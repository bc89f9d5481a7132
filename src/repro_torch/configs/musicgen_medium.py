"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings for train/prefill; decode runs over the 2048-entry codebook vocab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio_stub",
    source="arXiv:2306.05284",
)
