"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553; InternViT + InternLM2.  [arXiv:2404.16821; hf]

The InternViT frontend is a STUB: ``input_specs()`` provides precomputed
patch embeddings; this config describes the InternLM2 language backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    act="silu",
    frontend="vision_stub",
    source="arXiv:2404.16821",
)
