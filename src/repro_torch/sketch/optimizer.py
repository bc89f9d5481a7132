"""Sketched AdamW: (m, v) moments in CSVec tables (port of
``repro/sketch/optimizer.py``).

Both moment recursions are linear in the step's statistic and count
sketches are linear, so the EMAs run in sketch space exactly:

    m table = b1 * table + (1-b1) * CS(g)    signed count sketch, median
    v table = b2 * table + (1-b2) * CMS(g^2) count-min, min

Hashes are fixed per leaf and evaluated on the fly from O(1)
coefficients.  Every leaf with at least ``min_elems`` elements gets
tables of ``rows * cols ~= numel / ratio`` entries per moment; smaller
leaves keep dense f32 moments.

**Leaves are the reference's.**  The reference stacks each block
parameter as one (L, ...) leaf; the port keeps L per-layer tensors.  The
state follows ``models/transformer.py:param_leaves``: leaf i of the
reference's flatten order has one moments entry, and a stacked leaf's L
per-layer tensors are the pieces of one flat vector (layer l's element j
is coordinate ``l * numel_layer + j``).  Whether a leaf is sketched, its
columns (``_cols_for``) and its hash seeds (``_leaf_seed(seed, 2i)`` and
``2i + 1``) come from the stacked leaf, so the port's tables equal the
reference's for the same gradients.  Per leaf and step the update is one
``sketch_apply_op`` call: every piece is accumulated before any is
estimated, and the stacked gradient is never concatenated.  On the card
that is the fused form of the ``sketch_update`` kernels (the tables
updated slab by slab, then one launch that gathers each element's
estimates and takes its AdamW step, m_hat and v_hat never in memory); on
the CPU the plain version applies and frees each piece's estimates
before the next piece's are made.

Params and moments are updated in place (the reference returned new
pytrees).

Sketched Adagrad (``sketched_adagrad_init`` / ``_update``): the second
moment alone, accumulated rather than averaged, in one count-min table
per large leaf (seed ``_leaf_seed(seed, i)``, as the reference's), or
dense f32 pieces below ``min_elems``; the same leaf rules as sketched
AdamW.  Plain PyTorch on ``CSVec`` (the reference runs it in jnp, no
Pallas kernel); ``make_optimizer`` does not reach it, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.kernels.ops import sketch_apply_op
from repro_torch.models.sharding import is_dtensor, single_device_mesh, unwrap
from repro_torch.models.transformer import Params, param_leaves
from repro_torch.sketch.csvec import (CSVec, accumulate, csvec_zeros, query,
                                     state_bytes)
from repro_torch.train.optimizer import adamw_leaf_update, bias_corrections

DEFAULT_MIN_ELEMS = 1 << 16


@dataclasses.dataclass
class DenseMoments:
    m: List[torch.Tensor]     # f32, one per piece
    v: List[torch.Tensor]


@dataclasses.dataclass
class SketchedMoments:
    m: CSVec                  # signed count sketch of the stacked leaf
    v: CSVec                  # unsigned count-min


Moments = Union[DenseMoments, SketchedMoments]


@dataclasses.dataclass
class SketchedAdamWState:
    step: int                 # steps taken
    moments: List[Moments]    # one per reference leaf, param_leaves order


def _cols_for(numel: int, ratio: int, rows: int) -> int:
    """Per-row table width: numel/(rows*ratio) rounded up to lane-aligned
    multiples (128; 256 when large), as the reference."""
    c = -(-numel // (rows * ratio))
    align = 256 if c >= 2048 else 128
    return -(-c // align) * align


def _leaf_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (1 << 31)


def sketched_adamw_init(params: Params, ratio: int, rows: int = 3,
                        min_elems: int = DEFAULT_MIN_ELEMS,
                        seed: int = 0) -> SketchedAdamWState:
    moments: List[Moments] = []
    for i, (_, pieces) in enumerate(param_leaves(params)):
        numel = sum(p.numel() for p in pieces)
        dev = pieces[0].device
        if ratio > 0 and numel >= min_elems:
            cols = _cols_for(numel, ratio, rows)
            moments.append(SketchedMoments(
                m=csvec_zeros(numel, cols, rows, seed=_leaf_seed(seed, 2 * i),
                              signed=True, device=dev),
                v=csvec_zeros(numel, cols, rows,
                              seed=_leaf_seed(seed, 2 * i + 1),
                              signed=False, device=dev)))
        else:
            zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32,
                                         device=dev) for p in pieces]
            moments.append(DenseMoments(m=zeros(), v=zeros()))
    return SketchedAdamWState(step=0, moments=moments)


def sketched_adamw_update(grads: Params, state: SketchedAdamWState,
                          params: Params, lr: float = 3e-4, b1: float = 0.9,
                          b2: float = 0.95, eps: float = 1e-8,
                          weight_decay: float = 0.01,
                          use_kernel: Optional[bool] = None,
                          ) -> Tuple[Params, SketchedAdamWState]:
    """One sketched-AdamW step, in place on params and state: the
    reference's math, with f32 bias corrections.  DTensor params and
    grads on a one-device mesh step through their local tensors (the
    card's kernels); on a larger mesh this raises."""
    out = params
    if single_device_mesh(params, grads) is not None:
        params, grads = unwrap(params), unwrap(grads)
    elif any(is_dtensor(t) for _, ps in param_leaves(params) for t in ps):
        raise NotImplementedError(
            "sketched AdamW on parameters sharded over several devices")
    state.step += 1
    bc1, bc2 = bias_corrections(b1, b2, state.step)
    leaves = zip(param_leaves(params), param_leaves(grads), state.moments)
    for (_, ps), (_, gs), mo in leaves:
        if isinstance(mo, DenseMoments):
            for p, g, m, v in zip(ps, gs, mo.m, mo.v):
                adamw_leaf_update(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay, bc1=bc1,
                                  bc2=bc2)
            continue
        pieces, off = [], 0
        for g in gs:
            pieces.append((g.reshape(-1), off))
            off += g.numel()
        sketch_apply_op(pieces, ps, mo.m.table, mo.v.table, mo.m.coeffs,
                        mo.v.coeffs, b1=b1, b2=b2, lr=lr, eps=eps,
                        weight_decay=weight_decay, bc1=bc1, bc2=bc2,
                        use_kernel=use_kernel)
    return out, state


@dataclasses.dataclass
class SketchedAdagradState:
    step: int                 # steps taken
    # one per reference leaf, param_leaves order: a count-min CSVec of
    # the stacked leaf, or its dense f32 pieces
    moments: List[Union[CSVec, List[torch.Tensor]]]


def sketched_adagrad_init(params: Params, ratio: int, rows: int = 3,
                          min_elems: int = DEFAULT_MIN_ELEMS,
                          seed: int = 0) -> SketchedAdagradState:
    moments: List[Union[CSVec, List[torch.Tensor]]] = []
    for i, (_, pieces) in enumerate(param_leaves(params)):
        numel = sum(p.numel() for p in pieces)
        dev = pieces[0].device
        if ratio > 0 and numel >= min_elems:
            moments.append(csvec_zeros(
                numel, _cols_for(numel, ratio, rows), rows,
                seed=_leaf_seed(seed, i), signed=False, device=dev))
        else:
            moments.append([torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev) for p in pieces])
    return SketchedAdagradState(step=0, moments=moments)


def sketched_adagrad_update(grads: Params, state: SketchedAdagradState,
                            params: Params, lr: float = 1e-2,
                            eps: float = 1e-8
                            ) -> Tuple[Params, SketchedAdagradState]:
    """One sketched-Adagrad step, in place on params and state: v += g^2
    (every piece of a sketched leaf accumulated before any is read), then
    p -= lr g / (sqrt(max(v_hat, 0)) + eps)."""
    leaves = zip(param_leaves(params), param_leaves(grads), state.moments)
    for (_, ps), (_, gs), mo in leaves:
        sketched = isinstance(mo, CSVec)
        off = 0
        for i, g in enumerate(gs):
            if sketched:
                accumulate(mo, torch.square(g.float()), offset=off)
            else:
                mo[i].add_(torch.square(g.float()))
            off += g.numel()
        off = 0
        for i, (p, g) in enumerate(zip(ps, gs)):
            vh = mo[i] if not sketched else query(mo, torch.arange(
                off, off + p.numel(), device=p.device)).clamp_min(
                0.0).reshape(p.shape)
            off += p.numel()
            p.copy_((p.float() - lr * g.float() / (torch.sqrt(vh) + eps)
                     ).to(p.dtype))
    state.step += 1
    return params, state


def moment_state_bytes(state) -> dict:
    """Persistent moment-state bytes, split dense vs sketched, plus the
    bytes the sketched leaves would have cost dense (f32 m + v)."""
    dense = sketched = dense_equiv = 0
    for mo in state.moments:
        if isinstance(mo, SketchedMoments):
            sketched += state_bytes(mo.m) + state_bytes(mo.v)
            dense_equiv += 2 * mo.m.d * 4
        else:
            dense += sum(t.numel() * 4 for t in mo.m + mo.v)
    return {"dense": dense, "sketched": sketched,
            "sketched_dense_equiv": dense_equiv,
            "total": dense + sketched}
