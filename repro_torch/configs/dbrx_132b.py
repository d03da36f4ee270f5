"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.  Pure global
attention -> long_500k is SKIPPED (documented, DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=10752,
    vocab=100_352,
    pattern=("moe_global",),
    d_head=128,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
))
