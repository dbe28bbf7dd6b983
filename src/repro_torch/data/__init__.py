from .pipeline import DataConfig, SyntheticLM, make_train_batch

__all__ = ["DataConfig", "SyntheticLM", "make_train_batch"]
