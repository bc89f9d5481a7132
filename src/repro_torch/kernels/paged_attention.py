"""Wrapper of the Hopper split-KV paged-attention kernel
(``csrc/paged_attention.cu``), the port of the TPU kernel
``repro/kernels/paged_attention.py:paged_attention``.

Same interface as the reference: q (B, Sq, K, R, hd) bf16, pools
(NB, bs, K, hd) bf16, tables (B, nb) int32 (entries >= NB are dead),
start / fold_base (B,) int32 -> f32 (m, l, acc) shaped (B, K, R, Sq),
(B, K, R, Sq) and (B, K, R, Sq, hd).  The wrapper checks what the kernel
takes and raises on anything else, allocates the outputs and the split
scratch, launches on the current stream and raises if the launch was
refused.  It takes only CUDA tensors; ``kernels/ops.py`` sends CPU tensors
to the plain version.  ``paged_attention.launches`` counts calls: each
launches the split kernel once and, when ``plan`` gives more than one
split, the merge pass after it.

``plan`` is the kernel's work split, plain Python: a pure function of the
shapes and the SM count, never of ``start``, ``fold_base`` or the table
values, so a slot's output depends only on its own inputs and a call
needs no host sync.  Its KV splits do not depend on the query rows
either, so a row's output is the same at any Sq.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256          # 4 warps x 64 head dims in the kernel
MAX_SMEM_BYTES = 232_448    # opt-in shared memory per block on sm_90
STAGE_KEYS = 32             # kKeys: keys per staged KV tile
MAX_TILE_ROWS = 64          # query rows per tile: 16 (the MMA's M) to 64
BLOCKS_PER_SM = 2           # the planner's target for the grid
MAX_SPLITS = 64             # bounds the merge's f32 scratch at one slot


class Plan(NamedTuple):
    tile_rows: int          # query rows per tile, a multiple of 16
    tiles: int              # row tiles per (slot, kv head)
    splits: int             # KV splits per tile
    per_split: int          # logical blocks per split
    stage_blocks: int       # pool blocks per staged KV tile
    blocks: int             # thread blocks of the split kernel


def plan(B: int, K: int, NQ: int, nb: int, bs: int, sm_count: int) -> Plan:
    """Work split of one call: a kv head's NQ = R*Sq query rows in tiles of
    up to 64, and KV splits (contiguous ranges of the slot's nb logical
    blocks): as many as it takes for BLOCKS_PER_SM blocks per SM at one
    tile per (slot, kv head), at most one per logical block and at most
    MAX_SPLITS.  The splits depend on (B, K, nb, SMs) alone, never on NQ:
    a decode call (Sq 1), a verify call (Sq = spec_k + 1) and the draft's
    micro-steps see the same split boundaries, so each verify row is
    bitwise the decode row at its position."""
    tile_rows = min(MAX_TILE_ROWS, -(-NQ // 16) * 16)
    tiles = -(-NQ // tile_rows)
    want = -(-BLOCKS_PER_SM * sm_count // (B * K))
    per = max(1, nb // want, -(-nb // MAX_SPLITS))
    splits = max(1, -(-nb // per))
    return Plan(tile_rows, tiles, splits, per, max(1, STAGE_KEYS // bs),
                splits * tiles * B * K)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.paged_attention_launch.argtypes = (
        [_c_ptr] + [ctypes.c_longlong] * 4 + [_c_ptr] * 11 + [_c_int] * 13
        + [ctypes.c_float, _c_ptr])
    lib.paged_attention_launch.restype = _c_int
    lib.paged_attention_smem_bytes.argtypes = [_c_int, _c_int, _c_int]
    lib.paged_attention_smem_bytes.restype = _c_int
    lib._argtypes_set = True
    return lib


def _check(q, k_pool, v_pool, tables, start, fold_base):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    named = dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                 start=start, fold_base=fold_base)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_pool", "v_pool"):
        if named[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got "
                             f"{named[name].dtype}")
    for name in ("tables", "start", "fold_base"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{named[name].dtype}")
    if q.ndim != 5 or k_pool.ndim != 4:
        raise ValueError(f"q must be (B,Sq,K,R,hd) and pools (NB,bs,K,hd); "
                         f"got {tuple(q.shape)} / {tuple(k_pool.shape)}")
    B, Sq, K, R, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    if tuple(k_pool.shape) != (NB, bs, K, hd) or \
            v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be (B={B}, nb), got "
                         f"{tuple(tables.shape)}")
    if tuple(start.shape) != (B,) or tuple(fold_base.shape) != (B,):
        raise ValueError("start and fold_base must be (B,)")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of 8 and at "
                         f"most {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or any(st % 2 for st in q.stride()[:4]):
        raise ValueError(f"q's head-dim axis must be contiguous and its "
                         f"other strides even, got {q.stride()}")
    if not 1 <= bs <= STAGE_KEYS:
        raise ValueError(f"block size {bs} must be 1 to {STAGE_KEYS}")
    if B * K > 65535:
        raise ValueError(f"B * K = {B * K} exceeds the grid")
    for name in ("q", "k_pool", "v_pool"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    start: torch.Tensor, fold_base: torch.Tensor):
    """Flash-decode attention statistics through per-slot block tables
    on the card (see the module docstring for shapes)."""
    _check(q, k_pool, v_pool, tables, start, fold_base)
    B, Sq, K, R, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    nb = tables.shape[1]
    NQ = R * Sq
    pl = plan(B, K, NQ, nb, bs, sm_count(q.device.index))
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(hd, pl.tile_rows, pl.per_split)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"head dim {hd} x {pl.per_split} blocks per split "
                         f"needs {smem} B of shared memory, more than "
                         f"{MAX_SMEM_BYTES}")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, K, R, Sq), **f32)
    l = torch.empty((B, K, R, Sq), **f32)
    acc = torch.empty((B, K, R, Sq, hd), **f32)
    if pl.splits > 1:
        parts = (torch.empty((pl.splits, B, K, NQ), **f32),
                 torch.empty((pl.splits, B, K, NQ), **f32),
                 torch.empty((pl.splits, B, K, NQ, hd), **f32))
    else:                   # the kernel writes the outputs directly
        parts = (m, l, acc)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), *q.stride()[:4], k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), start.data_ptr(), fold_base.data_ptr(),
        *(t.data_ptr() for t in parts), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), B, Sq, K, R, hd, NB, bs, nb, pl.tile_rows, pl.tiles,
        pl.splits, pl.per_split, pl.stage_blocks, 1.0 / math.sqrt(hd),
        stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    paged_attention.launches += 1
    return m, l, acc


paged_attention.launches = 0
