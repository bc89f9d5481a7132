"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6, 2 shared experts (fine-grained).
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    act="silu",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_d_ff=1408),
    source="arXiv:2401.06066",
)
