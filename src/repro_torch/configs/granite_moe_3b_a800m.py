"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The assignment header says "MoE 40e top-8" while the trailing note says
"32 experts top-8"; we follow the structured field (40 experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    act="silu",
    moe=MoEConfig(num_experts=40, top_k=8, num_shared_experts=0,
                  expert_d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
