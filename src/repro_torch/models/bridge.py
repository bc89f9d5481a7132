"""Carries the JAX package's parameters into the port.

``from_reference`` takes the reference parameter tree
(``repro.models.transformer.init_params``) as numpy arrays — the caller
converts with ``jax.tree.map(np.asarray, params)``, so this module
imports nothing of JAX — and returns the port's parameter dict
(models/transformer.py), computing the same function.  bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays; their bits are reinterpreted
as ``torch.bfloat16``, which is exact.  The stacked (L, ...) block leaves
of the reference's scan-over-layers layout are split per layer (the
attention biases of a ``qkv_bias`` config and the moe family's f32
router and stacked experts with them).

``opt_state_from_reference`` carries the reference's optimizer state
(``AdamWState`` or ``SketchedAdamWState``, converted the same way) into
the port's, so a run of the reference can be continued by the port.

For the recurrent families the stacked leaves of each block kind
(``mlstm`` / ``slstm``; ``mamba`` and the stacked ``shared`` blocks)
split into per-layer dicts the same way.  ``state_from_reference``
carries a recurrent family's slot state (``init_cache`` or ``prefill``
output) into the port's layout.

``tail_from_reference`` carries a sketched engine's tail tables
(the reference's ``cache["tail"]``, {"k", "v"} of (L, B, Z, C, K, hd))
into the port's stacked (2, L, B, Z, C, K, hd) layout.

``mode_hashes_from_reference`` carries the reference's ``ModeHash``
tuple (``repro.core.hashes``) into the port's, tables rebuilt from the
same coefficients (equal bitwise), so both packages sketch with the same
hashes.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hashes import ModeHash, mode_hash_from_coeffs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (RECURRENT_FAMILIES, Params,
                                            _check_family, tree_map)
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
    top = {"embed": to_torch(tree["embed"], dev),
           "head": (None if tree.get("head") is None
                    else to_torch(tree["head"], dev)),
           "final_norm": to_torch(tree["final_norm"], dev)}
    if cfg.family in RECURRENT_FAMILIES:
        def pick(node: Any, i: int) -> Any:
            if isinstance(node, dict):
                return {k: pick(v, i) for k, v in node.items()}
            return to_torch(node[i], dev)

        def depth(node: Any) -> int:
            while isinstance(node, dict):
                node = next(iter(node.values()))
            return len(node)

        return {**top, "blocks": {
            kind: [pick(sub, i) for i in range(depth(sub))]
            for kind, sub in blocks.items()}}
    L = cfg.num_layers
    # the family's FFN subtree: the experts and the f32 router of the moe
    # family, the GLU of the others
    ffn = "moe" if cfg.family == "moe" else "ffn"

    def layer(sub: dict, i: int) -> dict:
        return {k: to_torch(v[i], dev) for k, v in sub.items()}

    return {
        **top,
        "blocks": [{"attn": layer(blocks["attn"], i),
                    ffn: layer(blocks[ffn], i),
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
            return [to_torch(a[i], dev) for i in range(a.shape[0])]
        return [to_torch(a, dev)]

    moments = []
    for path, mo in _moment_leaves(state.moments):
        if hasattr(mo.m, "table"):
            moments.append(SketchedMoments(m=csvec(mo.m), v=csvec(mo.v)))
        else:
            moments.append(DenseMoments(m=pieces(mo.m, path),
                                        v=pieces(mo.v, path)))
    return SketchedAdamWState(step=step, moments=moments)


def state_from_reference(state: Any, device: DeviceLike = None) -> dict:
    """A recurrent family's slot state from the reference (numpy leaves of
    ``init_cache`` or ``prefill`` output: ``jax.tree.map(np.asarray,
    cache)``) -> the port's, exactly; both stack every leaf on a leading
    layer (or group) axis, so only the arrays change."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_torch(a, dev), state)


def tail_from_reference(tail: Any, device: DeviceLike = None
                        ) -> torch.Tensor:
    """Reference tail tables {"k", "v"} (numpy) -> the port's stacked
    (2, L, B, Z, C, K, hd) f32 tensor (serve/kv_sketch.py), exactly."""
    dev = resolve_device(device)
    return torch.stack([to_torch(tail["k"], dev), to_torch(tail["v"], dev)])


def mode_hashes_from_reference(hashes: Any, device: DeviceLike = None
                               ) -> Tuple[ModeHash, ...]:
    """Reference ``ModeHash`` tuple (or one ``ModeHash``) -> the port's,
    on ``device``.  Each is rebuilt from its (D, 4) coefficients, which
    the reference stores modulo 2^31 (the identity below the prime), and
    its tables are checked against the reference's bitwise."""
    dev = resolve_device(device)
    single = hasattr(hashes, "coeffs")
    out = []
    for mh in ([hashes] if single else hashes):
        h = np.asarray(mh.h)
        port = mode_hash_from_coeffs(
            torch.from_numpy(np.asarray(mh.coeffs).astype(np.int64)),
            h.shape[1], int(mh.J), dev)
        if not (np.array_equal(port.h.cpu().numpy(), h) and np.array_equal(
                port.s.cpu().numpy(), np.asarray(mh.s))):
            raise ValueError("the reference's tables do not follow from "
                             "its coefficients")
        out.append(port)
    return out[0] if single else tuple(out)
