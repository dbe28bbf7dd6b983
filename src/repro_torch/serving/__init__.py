"""Serving layer of the port: continuous batching over a paged KV cache,
decode-shape bucketing and per-request-class dispatch-policy scopes.  See
``engine.ServeEngine``."""

from .buckets import BucketSpec, default_buckets
from .engine import QueueFullError, Request, RequestState, ServeEngine
from .kv_cache import PagedKVCache

__all__ = [
    "BucketSpec",
    "default_buckets",
    "PagedKVCache",
    "QueueFullError",
    "Request",
    "RequestState",
    "ServeEngine",
]
