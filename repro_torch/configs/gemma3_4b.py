"""gemma3-4b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt family; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.  Pattern: five
sliding-window-1024 layers then one global layer; 34 = 5x6 + 4 tail.
long_500k runs with global-layer decode cache bounded at 32768
(DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv=4,
    d_ff=10240,
    vocab=262_144,
    pattern=("local", "local", "local", "local", "local", "global"),
    d_head=256,
    local_window=1024,
    global_cache_cap=32_768,
    mlp_kind="geglu",
    emb_scale=True,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-4b-pt",
))
