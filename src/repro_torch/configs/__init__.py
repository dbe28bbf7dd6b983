"""Architecture configs of the port (``get_config``/``smoke_config``)."""

from .arch import ArchConfig, BlockCfg
from .registry import ARCHS, get_config, list_archs, smoke_config
from .shapes import SHAPES, ShapeCell, cache_specs, cell_applicable, input_specs

__all__ = ["ArchConfig", "BlockCfg", "ARCHS", "get_config", "list_archs", "smoke_config",
           "SHAPES", "ShapeCell", "input_specs", "cache_specs", "cell_applicable"]
