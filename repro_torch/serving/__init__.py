"""Serving layer: KV-cache accounting, serve loop, GUST-sparse decode."""

from .kv_cache import (CachePolicy, ShardedServeState, cache_bytes, cache_shardings,
                       cache_specs, gather_serve_state, init_serve_state, serve_placement,
                       shard_serve_state)
from .serve_loop import (
    RequestResult,
    RequestStatus,
    ServeConfig,
    ServeLoop,
    make_sampler,
    make_serve_fns,
)
from .gust_serve import GustServeConfig, gustify, decode_step_gust, dryrun_specs
