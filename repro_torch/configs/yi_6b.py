"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  Pure full
attention -> long_500k SKIPPED (DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64_000,
    pattern=("global",),
    d_head=128,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
))
