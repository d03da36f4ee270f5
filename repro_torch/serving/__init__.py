"""Serving layer: KV-cache accounting, serve loop, GUST-sparse decode."""

from .kv_cache import CachePolicy, cache_specs, cache_shardings, cache_bytes
from .serve_loop import (
    RequestResult,
    RequestStatus,
    ServeConfig,
    ServeLoop,
    make_sampler,
    make_serve_fns,
)
from .gust_serve import GustServeConfig, gustify, decode_step_gust, dryrun_specs
