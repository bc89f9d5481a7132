"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the dense attention configurations are ported so far; the other
families of the JAX package raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
}

# arch id -> the ROADMAP Queue 1 item that ports its family
_NOT_PORTED = {
    "granite-moe-3b-a800m": "Queue 1 #12 (MoE family)",
    "deepseek-moe-16b": "Queue 1 #12 (MoE family)",
    "musicgen-medium": "Queue 1 #12 (audio frontend stub)",
    "minitron-4b": "Queue 1 #12 (remaining dense configs)",
    "qwen2.5-32b": "Queue 1 #12 (remaining dense configs)",
    "xlstm-1.3b": "Queue 1 #12 (recurrent families)",
    "internvl2-2b": "Queue 1 #12 (vision frontend stub)",
    "zamba2-2.7b": "Queue 1 #12 (recurrent families)",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP "
            f"{_NOT_PORTED[arch]}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Reduced configs for CPU tests: same family/topology, tiny dims (the same
# reduction the JAX package applies, so the parity tests compare like
# with like).
# ---------------------------------------------------------------------------


def reduced_config(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        num_layers=2,
    )
