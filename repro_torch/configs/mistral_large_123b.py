"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  The largest
dense arch in the pool; 2-D (FSDP x TP) parameter sharding is what makes
it fit (DESIGN.md S7).  Pure full attention -> long_500k SKIPPED.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=28672,
    vocab=32_768,
    pattern=("global",),
    d_head=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
))
