"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2
[arXiv:2402.19427; unverified].

38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000.  Griffin
pattern: two recurrent blocks then one local-attention block (window
2048).  38 = 12x(rec,rec,local) + 2 tail (rec,rec).  Bounded state ->
runs long_500k.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256_000,
    pattern=("rec", "rec", "local"),
    d_head=256,
    local_window=2048,
    mlp_kind="geglu",
    emb_scale=True,
    source="arXiv:2402.19427",
))
