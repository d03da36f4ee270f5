"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  iRoPE-style
3:1 chunked-local : global attention (chunk 8192); every layer MoE with
16 experts top-1.  long_500k runs with the global layers' decode cache
bounded at 32768 (StreamingLLM-style ring; DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202_048,
    pattern=("moe_chunked", "moe_chunked", "moe_chunked", "moe_global"),
    d_head=128,
    chunk_size=8192,
    global_cache_cap=32_768,
    n_experts=16,
    top_k=1,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
