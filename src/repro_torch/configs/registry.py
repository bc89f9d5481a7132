"""Architecture registry of the port: ``--arch <id>`` resolution, the
JAX package's ten configs: the attention families (dense, moe, audio,
vlm) and the recurrent ones (ssm: xlstm-1.3b; hybrid: zamba2-2.7b).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "yi-9b": "repro_torch.configs.yi_9b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
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
    changes: dict = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.family == "moe":
        changes["num_layers"] = 2
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, expert_d_ff=64, group_size=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1))
    elif cfg.family == "ssm":
        # one whole xLSTM[7:1] group
        changes["num_layers"] = cfg.xlstm.m_per_group + cfg.xlstm.s_per_group
        changes["num_heads"] = 2
        changes["num_kv_heads"] = 2
    elif cfg.family == "hybrid":
        # two groups, so both shared blocks apply
        changes["num_layers"] = 2 * cfg.hybrid.mamba_per_group
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                             chunk=16)
    else:
        changes["num_layers"] = 2
    return dataclasses.replace(cfg, **changes)
