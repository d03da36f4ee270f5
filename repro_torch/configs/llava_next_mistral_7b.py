"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  Mistral-7B
backbone: sliding-window 4096 attention on every layer.  The vision
frontend (anyres patch tiler + projector) is a STUB: input_specs()
provides precomputed early-fusion embeddings (B, S, d) per the
assignment.  Bounded windows -> runs long_500k.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32_000,
    pattern=("local",),
    d_head=128,
    local_window=4096,
    frontend="embed",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
