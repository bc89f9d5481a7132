"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

Structure: 54 Mamba2 layers; after every 6 Mamba2 layers one of 2 shared
full transformer blocks (attention+FFN) is applied round-robin (real Zamba2
adds per-application LoRA deltas to the shared block — omitted, as in the
JAX package).  Each application of a shared block keeps its own KV cache.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    act="gelu",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk=64),
    hybrid=HybridConfig(mamba_per_group=6, num_shared_blocks=2),
    supports_long_context=True,
    source="arXiv:2411.15242",
)
