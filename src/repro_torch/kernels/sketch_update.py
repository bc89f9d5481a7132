"""Wrapper of the Hopper sketched-moment kernels (``csrc/sketch_update.cu``),
the port of the TPU kernel ``repro/kernels/sketch_update.py:
sketch_update``.

One leaf's (R, C) f32 moment tables are updated in place from its
gradient g, one flat vector given as pieces ``(g_piece, offset)`` (element
j of a piece is coordinate ``offset + j``) or strided pieces ``(g_piece,
offset, row, stride)`` (rows of ``row`` elements ``stride`` apart: one
rank's block of a parameter split along any one dim; ``kernels/ref.py:
piece_layout``):

  new_m = b1 * m + (1-b1) * CS(g),  new_v = b2 * v + (1-b2) * CMS(g^2),
  m_hat = median-of-rows of new_m,  v_hat = min-of-rows of new_v.

``accumulate`` updates the tables: the pieces are cut into groups whose
bin entries fit ``WORKSPACE_BYTES`` (``plan_groups``), and each group is
binned by table slab and added slab by slab (five launches a group; see
the kernel source).  Two forms then read the tables:

* ``sketch_update`` (the estimates form, the JAX op's contract) returns
  an iterator over each piece's f32 (m_hat, v_hat), one retrieve launch a
  piece, made when the iterator reaches it, so a caller can apply and free
  one piece's estimates before the next is made;
* ``sketch_apply`` (the fused form, the optimizer's path on the card)
  takes the AdamW step of the leaf's params from the estimates in one
  launch, in place, with ``sketched_leaf_update``'s arithmetic: m_hat and
  v_hat never reach memory.  ``step`` is that launch alone, from the
  tables as they are (the sharded optimizer's step from gathered tables).

The wrappers check what the kernels take and raise on anything else,
allocate the work space, launch on the current stream and raise if a
launch was refused.  They take only CUDA tensors; ``kernels/ops.py`` sends
CPU tensors to the plain versions.  ``sketch_update.launches`` counts
every launch of the kernels: five a group of the accumulate (three for a
group without elements), one a retrieve, one an apply.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import piece_layout
from repro_torch.sketch.hashing import coeff_bits

_c_int, _c_ll, _c_ptr, _c_float = (ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_float)

MAX_ROWS = 8                  # rows instantiated in the kernels
SLAB = 1 << 15                # kSlab: table cells a slab
MAX_SEGS = 64                 # kMaxSegs: pieces a launch
MAX_SLABS = 1 << 15           # kMaxBinsPerRow: slabs a table row
WORKSPACE_BYTES = 4 << 30     # bin entries of one group, at most

Piece = tuple       # (g, offset) or (g, offset, row, stride)
Layout = Tuple[torch.Tensor, int, int, int]     # piece_layout's
Segment = Tuple[int, int, int]          # (piece, first element, end)


def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_update")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.sketch_update_accumulate_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll,
        _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr, _c_float, _c_float, _c_float, _c_float,
        _c_int, _c_ptr]
    lib.sketch_update_accumulate_launch.restype = _c_int
    lib.sketch_update_retrieve_launch.argtypes = [
        _c_ll, _c_ll, _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,
        _c_ll, _c_ptr, _c_ptr, _c_ptr]
    lib.sketch_update_retrieve_launch.restype = _c_int
    lib.sketch_update_apply_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll, _c_float, _c_float,
        _c_float, _c_float, _c_float, _c_ptr]
    lib.sketch_update_apply_launch.restype = _c_int
    lib.sketch_update_limits.argtypes = [_c_ptr]
    lib.sketch_update_limits.restype = None
    limits = (_c_ll * 5)()
    lib.sketch_update_limits(limits)
    lib.window, lib.stage_bytes = limits[3], limits[4]   # for tile_for
    if tuple(limits[:3]) != (SLAB, MAX_SEGS, MAX_SLABS):
        raise RuntimeError(f"sketch_update kernel limits {list(limits)} do "
                           f"not match the wrapper's")
    lib._argtypes_set = True
    return lib


def entry_bytes(dtype: torch.dtype) -> int:
    """Bytes of one bin entry: 4 for a bf16 gradient, 8 for f32."""
    return 4 if dtype == torch.bfloat16 else 8


def tile_for(C: int, entry: int, window: int, stage_bytes: int) -> int:
    """Elements a count / scatter block takes: as many as keep a scatter
    window's expected entries at 90% of its ``stage_bytes`` of staging (a
    window of ``window`` of the row's slabs receives that share of the
    tile's entries), a multiple of 1024.  Longer tiles give the scatter
    longer runs of a slab's entries to write."""
    ns = -(-C // SLAB)
    tile = int(0.9 * (stage_bytes // entry) * ns / min(window, ns))
    return max(1024, tile // 1024 * 1024)


def plan_groups(numels: Sequence[int], rows: int, entry: int,
                budget: Optional[int] = None) -> List[List[Segment]]:
    """The accumulate's groups, in order: consecutive segments
    ``(piece, start, end)`` of the pieces, each group's 2 * rows entries
    an element within ``budget`` bytes and at most ``MAX_SEGS`` segments
    (a piece larger than the budget is cut).  At least one group, which
    may be empty, so the tables are always scaled.  ``budget`` defaults
    to ``WORKSPACE_BYTES``."""
    budget = WORKSPACE_BYTES if budget is None else budget
    cap = budget // (2 * rows * entry)
    if cap < 1:
        raise ValueError(f"work space of {budget} B holds no element")
    groups: List[List[Segment]] = [[]]
    room = cap
    for k, n in enumerate(numels):
        start = 0
        while start < n:
            if room == 0 or len(groups[-1]) == MAX_SEGS:
                groups.append([])
                room = cap
            end = min(n, start + room)
            groups[-1].append((k, start, end))
            room -= end - start
            start = end
    return groups


def _check(pieces: Sequence[Layout], m_table, v_table, coeffs_m,
           coeffs_v) -> None:
    dev = m_table.device
    if dev.type != "cuda":
        raise ValueError(f"sketch_update kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("m_table", m_table), ("v_table", v_table)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.ndim != 2:
            raise ValueError(f"{name} must be a contiguous 2-D float32 "
                             f"tensor on {dev}")
    if v_table.shape != m_table.shape:
        raise ValueError(f"tables {tuple(m_table.shape)} / "
                         f"{tuple(v_table.shape)} differ")
    R, C = m_table.shape
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"{R} rows; the kernel takes 1 to {MAX_ROWS}")
    if not 1 <= C <= MAX_SLABS * SLAB:
        raise ValueError(f"{C} columns; the kernel takes 1 to "
                         f"{MAX_SLABS * SLAB}")
    for name, c in (("coeffs_m", coeffs_m), ("coeffs_v", coeffs_v)):
        if c.device != dev or tuple(c.shape) != (R, 4):
            raise ValueError(f"{name} must be ({R}, 4) on {dev}, got "
                             f"{tuple(c.shape)} on {c.device}")
    dtypes = {g.dtype for g, *_ in pieces}
    if len(dtypes) > 1:
        raise ValueError(f"gradient pieces of one leaf share a dtype, got "
                         f"{sorted(map(str, dtypes))}")
    for g, offset, row, _ in pieces:
        if g.device != dev:
            raise ValueError(f"gradient piece on {g.device}, tables on "
                             f"{dev}")
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gradient pieces must be float32 or "
                             f"bfloat16, got {g.dtype}")
        if not g.is_contiguous():
            raise ValueError("gradient pieces must be contiguous")
        if int(offset) < 0:
            raise ValueError(f"piece offset {offset} is negative")
        if row and g.numel() >= 1 << 32:
            raise ValueError(f"a strided piece has {g.numel()} >= 2^32 "
                             f"elements")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"sketch_update {what} launch failed: CUDA "
                           f"error {err}")
    sketch_update.launches += 1


def _arrays(ptrs, offsets, numels, firsts, rows, strides):
    k = len(ptrs)
    return ((_c_ptr * k)(*ptrs),) + tuple(
        (_c_ll * k)(*a) for a in (offsets, numels, firsts, rows, strides))


def accumulate(pieces: Sequence[Piece], m_table: torch.Tensor,
               v_table: torch.Tensor, coeffs_m: torch.Tensor,
               coeffs_v: torch.Tensor, *, b1: float, b2: float) -> None:
    """Scale both tables and add every piece, in place (see the module
    docstring)."""
    pieces = [piece_layout(p) for p in pieces]
    _check(pieces, m_table, v_table, coeffs_m, coeffs_v)
    lib = _lib()
    R, C = m_table.shape
    dev = m_table.device
    dtype = pieces[0][0].dtype if pieces else torch.bfloat16
    esize = entry_bytes(dtype)
    groups = plan_groups([g.numel() for g, *_ in pieces], R, esize)
    NB = 2 * R * -(-C // SLAB)
    tile = tile_for(C, esize, lib.window, lib.stage_bytes)
    tiles = max(sum(-(-(e - s) // tile) for _, s, e in grp)
                for grp in groups)
    n_most = max(sum(e - s for _, s, e in grp) for grp in groups)
    counts = torch.empty(max(1, tiles * NB), dtype=torch.int32, device=dev)
    total = torch.empty(NB, dtype=torch.int32, device=dev)
    start = torch.empty(NB + 1, dtype=torch.int32, device=dev)
    ws = torch.empty(max(1, n_most * 2 * R * esize), dtype=torch.uint8,
                     device=dev)
    cm, cv = coeff_bits(coeffs_m), coeff_bits(coeffs_v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for gi, grp in enumerate(groups):
        ptrs = [pieces[k][0].data_ptr() + s * pieces[k][0].element_size()
                for k, s, _ in grp]
        arrs = _arrays(ptrs, [pieces[k][1] for k, _, _ in grp],
                       [e - s for _, s, e in grp], [s for _, s, _ in grp],
                       [pieces[k][2] for k, _, _ in grp],
                       [pieces[k][3] for k, _, _ in grp])
        err = lib.sketch_update_accumulate_launch(
            *arrs, len(grp), tile, int(dtype == torch.bfloat16),
            m_table.data_ptr(), v_table.data_ptr(), cm.data_ptr(),
            cv.data_ptr(), R, C, counts.data_ptr(), total.data_ptr(),
            start.data_ptr(), ws.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2,
            int(gi == 0), stream)
        if err != 0:
            raise RuntimeError(f"sketch_update accumulate launch failed: "
                               f"CUDA error {err}")
        sketch_update.launches += 5 if grp else 3


def sketch_update(pieces: Sequence[Piece], m_table: torch.Tensor,
                  v_table: torch.Tensor, coeffs_m: torch.Tensor,
                  coeffs_v: torch.Tensor, *, b1: float, b2: float
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Update the tables in place and return an iterator over each
    piece's (m_hat, v_hat) (the estimates form)."""
    pieces = [piece_layout(p) for p in pieces]
    accumulate(pieces, m_table, v_table, coeffs_m, coeffs_v, b1=b1, b2=b2)
    lib = _lib()
    R, C = m_table.shape
    cm, cv = coeff_bits(coeffs_m), coeff_bits(coeffs_v)
    stream = torch.cuda.current_stream(m_table.device).cuda_stream

    def estimates():
        for g, offset, row, stride in pieces:
            n = g.numel()
            m_hat = torch.empty(n, dtype=torch.float32, device=g.device)
            v_hat = torch.empty(n, dtype=torch.float32, device=g.device)
            _launched(lib.sketch_update_retrieve_launch(
                n, offset, row, stride, m_table.data_ptr(),
                v_table.data_ptr(),
                cm.data_ptr(), cv.data_ptr(), R, C, m_hat.data_ptr(),
                v_hat.data_ptr(), stream), "retrieve")
            yield m_hat, v_hat
            del m_hat, v_hat        # the caller's references free them

    return estimates()


def _params_for(pieces: Sequence[Layout], params: Sequence[torch.Tensor],
                m_table: torch.Tensor) -> List[torch.Tensor]:
    """``params`` as a list, checked against the pieces (``step``)."""
    params = list(params)
    if len(params) != len(pieces):
        raise ValueError(f"{len(params)} params for {len(pieces)} pieces")
    for p, (g, *_) in zip(params, pieces):
        if p.numel() != g.numel() or p.device != m_table.device \
                or not p.is_contiguous() \
                or p.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("each param must be a contiguous bf16 or f32 "
                             "tensor of its piece's numel on the tables' "
                             "device")
    if len({p.dtype for p in params}) > 1:
        raise ValueError("the params of one leaf share a dtype")
    return params


def step(pieces: Sequence[Piece], params: Sequence[torch.Tensor],
         m_table: torch.Tensor, v_table: torch.Tensor,
         coeffs_m: torch.Tensor, coeffs_v: torch.Tensor, *, lr: float,
         eps: float, weight_decay: float, bc1: float, bc2: float) -> None:
    """The AdamW step of each param piece (``params[k]`` of ``pieces[k]``'s
    numel, bf16 or f32, contiguous) in place from its estimates in the
    tables as they are: one launch a ``MAX_SEGS`` pieces."""
    pieces = [piece_layout(p) for p in pieces]
    params = _params_for(pieces, params, m_table)
    _check(pieces, m_table, v_table, coeffs_m, coeffs_v)
    if not pieces:
        return
    lib = _lib()
    R, C = m_table.shape
    cm, cv = coeff_bits(coeffs_m), coeff_bits(coeffs_v)
    stream = torch.cuda.current_stream(m_table.device).cuda_stream
    one = np.float32(1.0)
    inv1, inv2 = one / np.float32(bc1), one / np.float32(bc2)
    for k0 in range(0, len(pieces), MAX_SEGS):
        part = range(k0, min(len(pieces), k0 + MAX_SEGS))
        arrs = _arrays([params[k].data_ptr() for k in part],
                       [pieces[k][1] for k in part],
                       [pieces[k][0].numel() for k in part],
                       [0 for _ in part], [pieces[k][2] for k in part],
                       [pieces[k][3] for k in part])
        _launched(lib.sketch_update_apply_launch(
            *arrs, len(part), int(params[0].dtype == torch.bfloat16),
            m_table.data_ptr(), v_table.data_ptr(), cm.data_ptr(),
            cv.data_ptr(), R, C, float(inv1), float(inv2), eps,
            weight_decay, lr, stream), "apply")


def sketch_apply(pieces: Sequence[Piece], params: Sequence[torch.Tensor],
                 m_table: torch.Tensor, v_table: torch.Tensor,
                 coeffs_m: torch.Tensor, coeffs_v: torch.Tensor, *,
                 b1: float, b2: float, lr: float, eps: float,
                 weight_decay: float, bc1: float, bc2: float) -> None:
    """Update the tables in place, then take the AdamW step of each param
    piece in place from its estimates (``step``): the fused form."""
    pieces = list(pieces)
    params = _params_for([piece_layout(p) for p in pieces], params, m_table)
    accumulate(pieces, m_table, v_table, coeffs_m, coeffs_v, b1=b1, b2=b2)
    step(pieces, params, m_table, v_table, coeffs_m, coeffs_v, lr=lr,
         eps=eps, weight_decay=weight_decay, bc1=bc1, bc2=bc2)


sketch_update.launches = 0
