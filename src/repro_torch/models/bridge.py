"""Carries the JAX package's parameters into the port.

``from_reference`` takes the reference parameter tree
(``repro.models.transformer.init_params``) as numpy arrays — the caller
converts with ``jax.tree.map(np.asarray, params)``, so this module
imports nothing of JAX — and returns the port's parameter dict
(models/transformer.py), computing the same function.  bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays; their bits are reinterpreted
as ``torch.bfloat16``, which is exact.  The stacked (L, ...) block leaves
of the reference's scan-over-layers layout are split per layer.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Params, _check_family


def to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def from_reference(tree: Any, cfg: ModelConfig,
                   device: DeviceLike = None) -> Params:
    """Reference params (numpy leaves, stacked blocks) -> port params."""
    _check_family(cfg)
    dev = resolve_device(device)
    blocks = tree["blocks"]
    L = cfg.num_layers

    def layer(sub: dict, i: int) -> dict:
        return {k: to_torch(v[i], dev) for k, v in sub.items()}

    return {
        "embed": to_torch(tree["embed"], dev),
        "head": (None if tree.get("head") is None
                 else to_torch(tree["head"], dev)),
        "final_norm": to_torch(tree["final_norm"], dev),
        "blocks": [{"attn": layer(blocks["attn"], i),
                    "ffn": layer(blocks["ffn"], i),
                    "norm1": to_torch(blocks["norm1"][i], dev),
                    "norm2": to_torch(blocks["norm2"][i], dev)}
                   for i in range(L)],
    }
