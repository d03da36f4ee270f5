"""seamless-m4t-medium [audio] — encoder-decoder, multimodal
[arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096 vocab=256206.  The
speech frontend (conformer feature extractor) is a STUB: input_specs()
provides precomputed frame embeddings (B, S_enc, d).  12 encoder + 12
decoder layers; decoder self-attention is causal-global with
cross-attention into the encoder memory.  long_500k SKIPPED: a 0.5M-frame
source (~4.5 h audio) is out of spec for the model family (DESIGN.md S5).
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=256_206,
    pattern=("xattn",),
    d_head=64,
    mlp_kind="gelu",
    norm_kind="layer",
    frontend="encdec",
    n_enc_layers=12,
    enc_seq=4096,
    source="arXiv:2308.11596",
))
