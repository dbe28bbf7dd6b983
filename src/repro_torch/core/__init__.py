"""repro_torch.core -- the dispatch engine, the candidate registry, the
scoped selection policies, and the selector stack of the port: the
analytic cost model, measurement, datasets, the GBDT and the MTNN
selector."""

from .candidates import (
    BINARY_PAIRS_BY_OP,
    CANDIDATES,
    DEFAULT_BY_OP,
    PAPER_PAIR,
    get_candidate,
    register_candidate,
    unregister_candidate,
)
from .engine import (
    dispatch,
    dispatch_attention,
    dispatch_batched,
    dispatch_report,
    policy_from_spec,
)
from .dataset import (
    SelectionDataset,
    collect_analytic,
    collect_measured,
    dataset_from_measurements,
    paper_grid,
)
from .hardware import H100, SIMULATED_CHIPS, HardwareSpec, device_spec, host_spec
from .measure import (
    MeasurementCache,
    bench_fn,
    measure_candidates,
    measure_transpose_configs,
    tile_tables_from_cache,
    top_configs_by_candidate,
)
from .opkey import OPS, OpKey
from .policy import (
    AnalyticPolicy,
    AutotunePolicy,
    CascadePolicy,
    Decision,
    FixedPolicy,
    ModelPolicy,
    current_policy,
    default_policy,
    use_policy,
)
from .selector import MTNNSelector, default_selector, set_default_selector
from .train_model import kfold_cv, selection_metrics, train_kway_model, train_paper_model

__all__ = [
    "BINARY_PAIRS_BY_OP",
    "CANDIDATES",
    "DEFAULT_BY_OP",
    "PAPER_PAIR",
    "get_candidate",
    "register_candidate",
    "unregister_candidate",
    "dispatch",
    "dispatch_attention",
    "dispatch_batched",
    "dispatch_report",
    "policy_from_spec",
    "SelectionDataset",
    "collect_analytic",
    "collect_measured",
    "dataset_from_measurements",
    "paper_grid",
    "H100",
    "SIMULATED_CHIPS",
    "HardwareSpec",
    "device_spec",
    "host_spec",
    "MeasurementCache",
    "bench_fn",
    "measure_candidates",
    "measure_transpose_configs",
    "tile_tables_from_cache",
    "top_configs_by_candidate",
    "OPS",
    "OpKey",
    "AnalyticPolicy",
    "AutotunePolicy",
    "CascadePolicy",
    "Decision",
    "FixedPolicy",
    "ModelPolicy",
    "current_policy",
    "default_policy",
    "use_policy",
    "MTNNSelector",
    "default_selector",
    "set_default_selector",
    "kfold_cv",
    "selection_metrics",
    "train_kway_model",
    "train_paper_model",
]
