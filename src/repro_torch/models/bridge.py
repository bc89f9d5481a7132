"""Carries the JAX package's parameters into the port.

``from_reference`` takes the reference parameter tree
(``repro.models.transformer.init_params``) as numpy arrays — the caller
converts with ``jax.tree.map(np.asarray, params)``, so this module
imports nothing of JAX — and returns the port's parameter dict
(models/transformer.py), computing the same function.  bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays; their bits are reinterpreted
as ``torch.bfloat16``, which is exact.  The stacked (L, ...) block leaves
of the reference's scan-over-layers layout are split per layer.

``opt_state_from_reference`` carries the reference's optimizer state
(``AdamWState`` or ``SketchedAdamWState``, converted the same way) into
the port's, so a run of the reference can be continued by the port.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Params, _check_family
from repro_torch.sketch.csvec import CSVec
from repro_torch.sketch.optimizer import (DenseMoments, SketchedAdamWState,
                                          SketchedMoments)
from repro_torch.train.optimizer import AdamWState


def to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, bit for bit.  Always a
    copy: ``np.asarray`` of a JAX array is a read-only view of JAX's
    buffer, and the port updates its params and optimizer state in
    place."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16).astype(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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


def _moment_leaves(tree: Any, path: str = ""):
    """(path, moments) in the reference's flatten order (sorted keys;
    ``None`` drops out); a moments object has ``m`` and ``v``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _moment_leaves(tree[k],
                                        f"{path}/{k}" if path else k)]
    return [(path, tree)]


def opt_state_from_reference(state: Any, cfg: ModelConfig,
                             device: DeviceLike = None):
    """Reference optimizer state (numpy leaves: ``jax.tree.map(np.asarray,
    state)``) -> the port's ``AdamWState`` or ``SketchedAdamWState``,
    matching ``from_reference``'s params.  Tables, coefficients, moments
    and the step carry over exactly; stacked dense moments are split per
    layer like the params."""
    dev = resolve_device(device)
    step = int(np.asarray(state.step))
    if not hasattr(state, "moments"):
        return AdamWState(step=step, m=from_reference(state.m, cfg, dev),
                          v=from_reference(state.v, cfg, dev))

    def csvec(c) -> CSVec:
        return CSVec(table=to_torch(c.table, dev),
                     coeffs=to_torch(np.asarray(c.coeffs).astype(np.int64),
                                     dev),
                     d=int(c.d), signed=bool(c.signed), seed=int(c.seed))

    def pieces(a, path: str):
        a = np.asarray(a)
        if path.startswith("blocks/"):
            return [to_torch(a[i], dev) for i in range(cfg.num_layers)]
        return [to_torch(a, dev)]

    moments = []
    for path, mo in _moment_leaves(state.moments):
        if hasattr(mo.m, "table"):
            moments.append(SketchedMoments(m=csvec(mo.m), v=csvec(mo.v)))
        else:
            moments.append(DenseMoments(m=pieces(mo.m, path),
                                        v=pieces(mo.v, path)))
    return SketchedAdamWState(step=step, moments=moments)
