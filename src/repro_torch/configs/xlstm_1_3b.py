"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304;
sLSTM + mLSTM blocks (xLSTM[7:1] pattern).  [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (proj factor 2 for
mLSTM, 4/3 for sLSTM) instead of a separate FFN.
Attention-free: the decode state has a constant size whatever the context.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    act="gelu",
    xlstm=XLSTMConfig(m_per_group=7, s_per_group=1),
    supports_long_context=True,
    source="arXiv:2405.04517",
)
