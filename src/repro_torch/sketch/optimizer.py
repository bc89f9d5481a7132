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

**Sharded parameters.**  DTensor params on a one-device mesh step through
their local tensors.  On a larger mesh (FSDP or TP placements) the dense
leaves' moments are DTensors placed like their params and step shard by
shard; a sketched leaf's tables are DTensors placed as
``launch/shardings.py:opt_state_pspecs`` places them (columns split,
``table_spec``) and stay so between steps.  A step of a sketched leaf
(``_sharded_tables``, shared by both optimizers) rests on count sketch
being linear: each rank sketches its own elements, at their coordinates
in the whole leaf (one strided piece per local block, ``shard_pieces``),
into zero full-width tables (b1 = b2 = 0: CS(g) and CMS(g^2)); the
partial tables are reduce-scattered onto the column shards; each rank
folds the sum into its shard (``b * table + (1 - b) * sum``, the plain
version's expression); the tables are all-gathered, and each rank steps
its local elements from them (the median / min over every row).  A piece
replicated over a mesh dim is sketched only by the ranks at coordinate 0
of that dim, so every element is counted once.

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
import itertools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.ops import (sketch_accumulate_op, sketch_apply_op,
                                     sketch_step_op)
from repro_torch.kernels.ref import piece_coords, piece_layout
from repro_torch.models.sharding import is_dtensor, single_device_mesh, unwrap
from repro_torch.models.transformer import Params, param_leaves
from repro_torch.sketch.csvec import (CSVec, accumulate, accumulate_coords,
                                     csvec_zeros, query, state_bytes)
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


def _sharded_mesh(params: Params):
    """The mesh of ``params``' DTensors when it has more than one device,
    else None."""
    for _, pieces in param_leaves(params):
        for t in pieces:
            if is_dtensor(t):
                mesh = t.device_mesh
                return mesh if mesh.size() > 1 else None
    return None


def _table(mesh, rows: int, cols: int, device) -> torch.Tensor:
    """A zero (rows, cols) f32 sketch table: plain, or on a sharded mesh a
    DTensor with ``table_spec``'s placements (columns split)."""
    if mesh is None:
        return torch.zeros((rows, cols), dtype=torch.float32, device=device)
    from torch.distributed.tensor import zeros

    from repro_torch.launch.shardings import table_spec
    from repro_torch.models.sharding import placements
    spec = table_spec(torch.empty((rows, cols), device="meta"))
    return zeros((rows, cols), dtype=torch.float32, device_mesh=mesh,
                 placements=placements(spec, mesh))


def _csvec(mesh, numel: int, cols: int, rows: int, seed: int, signed: bool,
           device) -> CSVec:
    sk = csvec_zeros(numel, cols, rows, seed=seed, signed=signed,
                     device=device)
    if mesh is not None:
        sk.table = _table(mesh, rows, cols, device)
    return sk


def _dense_zeros(p: torch.Tensor) -> torch.Tensor:
    """Zero f32 moments of one param piece, placed like it on a sharded
    mesh."""
    if is_dtensor(p) and p.device_mesh.size() > 1:
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sketched_adamw_init(params: Params, ratio: int, rows: int = 3,
                        min_elems: int = DEFAULT_MIN_ELEMS,
                        seed: int = 0) -> SketchedAdamWState:
    moments: List[Moments] = []
    mesh = _sharded_mesh(params)
    for i, (_, pieces) in enumerate(param_leaves(params)):
        numel = sum(p.numel() for p in pieces)
        dev = pieces[0].device
        if ratio > 0 and numel >= min_elems:
            cols = _cols_for(numel, ratio, rows)
            moments.append(SketchedMoments(
                m=_csvec(mesh, numel, cols, rows, _leaf_seed(seed, 2 * i),
                         True, dev),
                v=_csvec(mesh, numel, cols, rows, _leaf_seed(seed, 2 * i + 1),
                         False, dev)))
        else:
            moments.append(DenseMoments(m=[_dense_zeros(p) for p in pieces],
                                        v=[_dense_zeros(p) for p in pieces]))
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
    card's kernels); on a larger mesh each rank steps its shards, the
    sketched leaves through ``_sharded_tables`` (module docstring)."""
    out = params
    mesh = _sharded_mesh(params)
    if single_device_mesh(params, grads) is not None:
        params, grads = unwrap(params), unwrap(grads)
    state.step += 1
    bc1, bc2 = bias_corrections(b1, b2, state.step)
    step_kw = dict(lr=lr, eps=eps, weight_decay=weight_decay, bc1=bc1,
                   bc2=bc2)
    leaves = zip(param_leaves(params), param_leaves(grads), state.moments)
    for (_, ps), (_, gs), mo in leaves:
        if isinstance(mo, DenseMoments):
            for p, g, m, v in zip(ps, gs, mo.m, mo.v):
                p, g, m, v = _locals(p, g, m, v)
                adamw_leaf_update(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay, bc1=bc1,
                                  bc2=bc2)
            continue
        if mesh is not None:
            owned, mine, params_l = shard_pieces(ps, gs, mesh)
            zm, zv = (torch.zeros(mo.m.table.shape, dtype=torch.float32,
                                  device=mo.m.coeffs.device)
                      for _ in range(2))
            sketch_accumulate_op(owned, zm, zv, mo.m.coeffs, mo.v.coeffs,
                                 b1=0.0, b2=0.0, use_kernel=use_kernel)
            full_m, full_v = _sharded_tables(
                mesh, [(mo.m.table, zm, b1), (mo.v.table, zv, b2)])
            del zm, zv
            # view(-1): a local block is contiguous, and a copy would
            # drop the step
            sketch_step_op(mine, [p.view(-1) for p in params_l], full_m,
                           full_v, mo.m.coeffs, mo.v.coeffs,
                           use_kernel=use_kernel, **step_kw)
            continue
        pieces, off = [], 0
        for g in gs:
            pieces.append((g.reshape(-1), off))
            off += g.numel()
        sketch_apply_op(pieces, ps, mo.m.table, mo.v.table, mo.m.coeffs,
                        mo.v.coeffs, b1=b1, b2=b2, use_kernel=use_kernel,
                        **step_kw)
    return out, state


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------


def _locals(*ts: torch.Tensor) -> List[torch.Tensor]:
    """Each tensor's local shard, redistributed first to the first one's
    placements where a DTensor's differ (a plain tensor as it is)."""
    first = ts[0]
    out = []
    for t in ts:
        if is_dtensor(t):
            if tuple(t.placements) != tuple(first.placements):
                t = t.redistribute(first.device_mesh, first.placements)
            t = t.to_local()
        out.append(t)
    return out


def block_pieces(shape: Sequence[int], local_shape: Sequence[int],
                 global_offset: Sequence[int], base: int
                 ) -> List[Tuple[Tuple[int, ...], int, int, int]]:
    """The strided pieces of one rank's block of a tensor of ``shape``
    whose elements are the coordinates ``base`` .. ``base + numel - 1``
    of a flat leaf: the block has ``local_shape`` at ``global_offset``.
    Returns [(index into the block, offset, row, stride)]: the block's
    sub-tensor ``block[index]``, flattened, is the piece ``(offset, row,
    stride)`` (``kernels/ref.py:piece_layout``).  A block split along one
    dim (every FSDP and TP placement) is one piece; only dims split
    before the last split one add pieces (the dims between them are
    whole, so the rows of one sub-tensor lie a fixed stride apart)."""
    shape, local = list(shape), list(local_shape)
    split = [d for d in range(len(shape)) if local[d] != shape[d]]
    if not split or not math.prod(local):
        return [((), base, 0, 0)] if math.prod(local) else []
    d = split[-1]
    inner = math.prod(shape[d + 1:])
    gstride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    outer = split[-2] + 1 if len(split) > 1 else 0
    out = []
    for idx in itertools.product(*(range(n) for n in local[:outer])):
        off = base + global_offset[d] * inner + sum(
            (global_offset[i] + j) * gstride[i] for i, j in enumerate(idx))
        out.append((idx, off, local[d] * inner, shape[d] * inner))
    return out


def shard_pieces(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                 mesh):
    """This rank's pieces of a sharded leaf: (the gradient pieces it
    sketches, every gradient piece of its blocks, the matching param
    pieces).  Piece k of the leaf starts at the sum of the earlier
    pieces' numels; each rank's block of it is ``block_pieces``'.  A
    piece replicated over a mesh dim is sketched only at coordinate 0 of
    that dim."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    coord = mesh.get_coordinate()
    owned, mine, params = [], [], []
    base = 0
    for p, g in zip(ps, gs):
        pl = tuple(p.placements)
        local, offset = compute_local_shape_and_global_offset(
            p.shape, mesh, pl)
        pt, gt = _locals(p, g)
        counted = all(isinstance(x, Shard) or c == 0
                      for x, c in zip(pl, coord))
        for idx, off, row, stride in block_pieces(p.shape, local, offset,
                                                  base):
            piece = (gt[idx].reshape(-1), off, row, stride)
            mine.append(piece)
            params.append(pt[idx])
            if counted:
                owned.append(piece)
        base += p.numel()
    return owned, mine, params


def _sharded_tables(mesh, updates) -> List[torch.Tensor]:
    """Fold each rank's partial table into the placed table and return the
    tables whole: for each (table, partial, b) the partial tables of every
    rank are summed onto the table's placements (a reduce-scatter onto
    column shards), the local shard becomes ``b * shard + (1 - b) *
    sum`` (b None: ``shard + sum``), and the table is all-gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    out = []
    for table, partial, b in updates:
        pl = (tuple(table.placements) if is_dtensor(table)
              else (Replicate(),) * mesh.ndim)
        total = DTensor.from_local(partial, mesh, (Partial(),) * mesh.ndim,
                                   run_check=False).redistribute(
                                       mesh, pl).to_local()
        mine = table.to_local() if is_dtensor(table) else table
        if b is None:
            mine.add_(total)
        else:
            mine.copy_(b * mine + (1.0 - b) * total)
        del total
        out.append(table.full_tensor() if is_dtensor(table) else table)
    return out


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
    mesh = _sharded_mesh(params)
    for i, (_, pieces) in enumerate(param_leaves(params)):
        numel = sum(p.numel() for p in pieces)
        dev = pieces[0].device
        if ratio > 0 and numel >= min_elems:
            moments.append(_csvec(mesh, numel, _cols_for(numel, ratio, rows),
                                  rows, _leaf_seed(seed, i), False, dev))
        else:
            moments.append([_dense_zeros(p) for p in pieces])
    return SketchedAdagradState(step=0, moments=moments)


def sketched_adagrad_update(grads: Params, state: SketchedAdagradState,
                            params: Params, lr: float = 1e-2,
                            eps: float = 1e-8
                            ) -> Tuple[Params, SketchedAdagradState]:
    """One sketched-Adagrad step, in place on params and state: v += g^2
    (every piece of a sketched leaf accumulated before any is read), then
    p -= lr g / (sqrt(max(v_hat, 0)) + eps).  DTensor params as for
    ``sketched_adamw_update``: through their local tensors on a
    one-device mesh, shard by shard on a larger one."""
    out = params
    mesh = _sharded_mesh(params)
    if single_device_mesh(params, grads) is not None:
        params, grads = unwrap(params), unwrap(grads)
    leaves = zip(param_leaves(params), param_leaves(grads), state.moments)
    for (_, ps), (_, gs), mo in leaves:
        sketched = isinstance(mo, CSVec)
        if mesh is not None:
            if sketched:
                _adagrad_sharded(ps, gs, mo, mesh, lr, eps)
                continue
            ps, gs, mo = zip(*(_locals(p, g, v)
                               for p, g, v in zip(ps, gs, mo)))
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
    return out, state


def _adagrad_sharded(ps, gs, mo: CSVec, mesh, lr: float, eps: float) -> None:
    """A sketched Adagrad leaf on a sharded mesh (module docstring): this
    rank's CMS(g^2) into a zero table, folded into the placed table as
    ``shard + sum``, then each local element's step from the gathered
    table."""
    owned, mine, params_l = shard_pieces(ps, gs, mesh)
    part = CSVec(table=torch.zeros(mo.table.shape, dtype=torch.float32,
                                   device=mo.coeffs.device),
                 coeffs=mo.coeffs, d=mo.d, signed=False)
    for g, off, row, stride in map(piece_layout, owned):
        accumulate_coords(part, piece_coords(g.numel(), off, row, stride,
                                             g.device),
                          torch.square(g.float()))
    (full,) = _sharded_tables(mesh, [(mo.table, part.table, None)])
    del part
    whole = CSVec(table=full, coeffs=mo.coeffs, d=mo.d, signed=False)
    for p, (g, off, row, stride) in zip(params_l, map(piece_layout, mine)):
        p = p.view(-1)
        vh = query(whole, piece_coords(g.numel(), off, row, stride,
                                       g.device)).clamp_min(0.0)
        p.copy_((p.float() - lr * g.float() / (torch.sqrt(vh) + eps)
                 ).to(p.dtype))


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
