"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064.  Pure full
attention -> long_500k SKIPPED (DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32_064,
    pattern=("global",),
    d_head=96,
    source="arXiv:2404.14219",
))
