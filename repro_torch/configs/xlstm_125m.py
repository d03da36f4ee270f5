"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own projections (mLSTM pre-up-projection pf=2, sLSTM post
gated FFN pf=4/3), so there is no separate transformer MLP.  Fully
recurrent -> O(1) decode state: runs long_500k.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517",
))
