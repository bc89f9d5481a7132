"""Wrappers of the Hopper count-sketch kernels (``csrc/count_sketch.cu``),
the ports of the TPU kernels ``repro/kernels/count_sketch.py:count_sketch``
and ``repro/kernels/unsketch.py:unsketch``.

Both take D stacked hash rows ``h`` (D, I) int32 and ``s`` (D, I) f32 and
do every repetition in one launch; a 1-D table (I,) is the reference's
call (D = 1, no leading axis in the result).

``count_sketch(x, h, s, J, index=None)``: x (B, I) f32 or bf16 ->
(D, B, J) in x's type, ``out[d, b, j] = sum_{h_d(i) = j} s_d(i) x[b, i]``
accumulated in f32.  The kernel streams x in coalesced tiles of ``TILE``
entries into f32 bucket accumulators in shared memory (bound: bytes, x
read once for all repetitions of a block).  Within a tile the first entry
of each bucket sums the bucket's entries in order, through the hash's
bucket links (``bucket_links``: each entry's next entry of the tile in its
bucket, and its sign), and adds the sum once.  The links belong to the
hash and are built once with it (``core/hashes.py:ModeHash``); a bare
``(h, s)`` call builds them here.  ``plan`` picks the branch from the
shapes alone: whole-J accumulators or J-slabs, and the split of I into
chunks, whose partial sums a second launch adds in order.  The order of
additions is fixed by the hash and (B, I, J), never by D or by the run
(``ref.count_sketch_tiled_ref`` is its plain model); a caller that passes
``chunks=1`` fixes it by the hash and (I, J) alone, so a row's sketch is
the same bits whatever B the call has.  Tables hold
0 <= h < J (the port's ``ModeHash`` guarantees it; the wrapper does not
sync to check); an entry with h outside [0, J) contributes nothing, as in
the TPU kernel.

``unsketch(y, h, s)``: y (B, J) shared by every repetition, or (D, B, J)
-> (D, B, I) in y's type, ``out[d, b, i] = s_d(i) * y[d, b, h_d(i)]``,
bitwise the plain version.  Each thread reads 4 entries' h and s with
vector loads and gathers them for ``unsketch_rows`` rows b (bound: bytes,
the tables read once for all rows where I fills the card).  An entry
with h outside [0, J) reads 0, as the Pallas kernel's one-hot does, where
``jnp`` indexing would clamp and the plain version raises; no table of
the port is out of range, so no path sees the difference.

Both check what the kernels take and raise on anything else, allocate
the output (and the chunks' partials), launch on the current stream and
raise if a launch was refused.  They take only CUDA tensors;
``kernels/ops.py`` sends CPU tensors to the plain versions.
``count_sketch.launches`` and ``unsketch.launches`` count calls (one
each; a count sketch of more than one chunk also launches the combine).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

TILE = 2048                 # kTile: entries per tile of the bucket links
STAGES = 3                  # kStages: x ring depth of a block
MAX_SMEM_BYTES = 232_448    # opt-in shared memory per block on sm_90
SMS = 132                   # H100 SXM; sizes the grid of ``plan``
MAX_CHUNKS = 1024
MIN_SLAB = 1024             # buckets per slab when slabs only add blocks
HAS_NEXT, HAS_PREV, SIGN_BIT = 1 << 11, 1 << 12, 1 << 15
UNSKETCH_THREADS = 256      # kUThreads: 4 entries each

_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

Index = torch.Tensor        # bucket_links(h, s, J): (D, I) int16


class Plan(NamedTuple):
    rows: int               # R: rows of x per block, 1, 2 or 4
    reps: int               # repetitions per block, 1 or 2
    slab: int               # JS: buckets per block
    slabs: int              # ceil(J / JS)
    chunks: int             # P: chunks of I, each of whole tiles
    tiles_per_chunk: int
    blocks: int

    @property
    def branch(self) -> str:
        where = ("shared-memory buckets" if self.slabs == 1 else
                 f"{self.slabs} J-slabs of {self.slab}")
        split = ("1 I-chunk" if self.chunks == 1 else
                 f"{self.chunks} I-chunks + combine")
        return (f"{where}, {split}, R={self.rows}, {self.reps} rep(s) a "
                f"block, {self.blocks} blocks")


def smem_bytes(reps: int, rows: int, slab: int, esize: int) -> int:
    """Shared memory of one block: the accumulators, the x ring and the
    tile's link words."""
    return (-(-reps * slab * rows * 4 // 16) * 16
            + STAGES * rows * TILE * esize + reps * TILE * 2)


@functools.lru_cache(maxsize=None)
def plan(D: int, B: int, I: int, J: int, esize: int,
         chunks: Optional[int] = None) -> Plan:
    """The work split of a count sketch of x (B, I) (``esize`` bytes an
    element) under D hash rows into J buckets, plain Python.

    Chunks: I splits into P chunks of whole tiles, P from (B, I, J) alone,
    so a repetition's sums never depend on D.  P minimises a model of
    the time: waves of blocks of 2 rows over ``SMS`` SMs, each streaming
    its chunk, plus the partials written and read.  Then as many repetitions (2 before 1, so
    x is read once for both) and rows (4, 2, 1) per block as let the J
    accumulators fit.  If none does, J-slabs of 1 row: each slab re-reads
    x and the tables, so the slabs are as few and as wide as fit.  A grid
    short of ``SMS`` blocks takes 1 repetition a block and, when x is no
    longer than a row of the output (I <= J, so re-reading it is cheap),
    narrower slabs, up to one wave of blocks.  ``chunks`` given: I splits
    into that many chunks (at most one a tile) instead."""
    tiles = max(1, -(-I // TILE))
    r_ref = min(B, 2)
    groups = -(-B // r_ref)
    best = None
    for P in range(1, min(tiles, MAX_CHUNKS) + 1):
        per = -(-tiles // P)
        P = -(-tiles // per)
        waves = -(-groups * P // SMS)
        cost = (waves * SMS * per * TILE * r_ref * 4
                + (8 * P * B * J if P > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, per)
    per = best[1] if chunks is None else -(-tiles // max(1, chunks))
    chunks = -(-tiles // per)

    rmax = 1 if B == 1 else 2 if B == 2 else 4
    reps_first = (2, 1) if D % 2 == 0 else (1,)
    fit = [(nd, R) for nd in reps_first for R in (4, 2, 1)
           if R <= rmax and smem_bytes(nd, R, J, esize) <= MAX_SMEM_BYTES]
    if fit:
        nd, R = fit[0]
        slab, slabs = J, 1
    else:
        nd, R = 1, 1
        cap = (MAX_SMEM_BYTES - smem_bytes(1, 1, 0, esize)) // 16 * 4
        slabs = -(-J // cap)
        slab = -(-J // slabs)
    groups = -(-B // R)
    if groups * chunks * slabs * (D // nd) < SMS and nd == 2:
        nd = 1
    per_slab = groups * chunks * (D // nd)
    if per_slab * slabs < SMS and I <= J:
        want = min(max(1, SMS // per_slab), max(slabs, -(-J // MIN_SLAB)))
        if want > slabs:
            slab = -(-J // want)
            slabs = -(-J // slab)
    return Plan(R, nd, slab, slabs, chunks, per, per_slab * slabs)


def bucket_links(h: torch.Tensor, s: torch.Tensor, J: int) -> Index:
    """The count-sketch kernel's chains for hash rows (h, s) (D, I) or
    (I,), on h's device: (D, I) int16 link words.  For each entry i of a
    tile of ``TILE`` (i // TILE), bits 0-10 hold the offset in the tile of
    the next entry of the tile in the same bucket, valid where bit 11
    (``HAS_NEXT``) is set; bit 12 (``HAS_PREV``) is set where an earlier
    entry of the tile shares the bucket; bit 15 (``SIGN_BIT``) where
    s(i) < 0.  Entries with h outside [0, J) are in no chain."""
    h2 = h.reshape(-1, h.shape[-1]).long()
    s2 = s.reshape(-1, s.shape[-1])
    D, I = h2.shape
    pos = torch.arange(I, device=h.device)
    valid = (h2 >= 0) & (h2 < J)
    key = (pos // TILE) * (J + 1) + torch.where(valid, h2, J)
    srt, perm = torch.sort(key, dim=-1, stable=True)
    same = (srt[:, 1:] == srt[:, :-1]) & valid.gather(1, perm[:, 1:])
    word = torch.where(s2 < 0, SIGN_BIT, 0)
    nxt = torch.where(same, perm[:, 1:] % TILE | HAS_NEXT, 0)
    word = word.scatter_add(1, perm[:, :-1], nxt)
    word = word.scatter_add(1, perm[:, 1:], torch.where(same, HAS_PREV, 0))
    return word.to(torch.int16)


def unsketch_rows(D: int, B: int, I: int) -> int:
    """Rows of y an unsketch thread walks: all B when the (i tile, d)
    blocks alone fill two waves of ``SMS``, else fewer, the rest of the
    rows in more blocks (at most 65,535 row groups)."""
    blocks = -(-I // (4 * UNSKETCH_THREADS)) * D
    groups = min(B, max(1, -(-2 * SMS // blocks)))
    return max(-(-B // groups), -(-B // 65535))


def _lib() -> ctypes.CDLL:
    lib = build.load("count_sketch")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.count_sketch_launch.argtypes = (
        [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
         _c_ll] + [_c_int] * 9 + [_c_ptr])
    lib.count_sketch_launch.restype = _c_int
    lib.unsketch_launch.argtypes = [
        _c_ptr, _c_int, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_int, _c_ll, _c_int, _c_int, _c_ptr]
    lib.unsketch_launch.restype = _c_int
    lib._argtypes_set = True
    return lib


def _tables(h: torch.Tensor, s: torch.Tensor, dev: torch.device,
            what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    for name, t in (("h", h), ("s", s)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
    if h.ndim not in (1, 2) or tuple(s.shape) != tuple(h.shape):
        raise ValueError(f"h and s must be (I,) or (D, I) alike; got "
                         f"{tuple(h.shape)} / {tuple(s.shape)}")
    if h.dtype != torch.int32 or s.dtype != torch.float32:
        raise ValueError(f"h must be int32 and s float32; got {h.dtype} / "
                         f"{s.dtype}")
    if not (h.is_contiguous() and s.is_contiguous()):
        raise ValueError("h and s must be contiguous")
    h2, s2 = h.reshape(-1, h.shape[-1]), s.reshape(-1, s.shape[-1])
    if not 1 <= h2.shape[0] <= 65535 or h2.shape[1] >= 2 ** 31:
        raise ValueError(f"tables of {h2.shape[0]} rows x {h2.shape[1]}: "
                         f"the kernels take 1 to 65535 rows below 2^31")
    return h2, s2


def _aligned(*pairs) -> bool:
    return all(t.data_ptr() % n == 0 for t, n in pairs)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def count_sketch(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor, J: int,
                 index: Optional[Index] = None,
                 chunks: Optional[int] = None) -> torch.Tensor:
    """x (B, I) -> (D, B, J), or (B, J) for 1-D tables; see the module
    docstring.  ``index`` is ``bucket_links(h, s, J)``, built here when
    not given; ``chunks`` overrides ``plan``'s split of I."""
    dev = x.device
    h2, s2 = _tables(h, s, dev, "count_sketch")
    D, I = h2.shape
    J = int(J)
    if x.ndim != 2 or x.shape[1] != I:
        raise ValueError(f"x must be (B, {I}), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= J < 2 ** 31:
        raise ValueError(f"J={J} must lie in [1, 2^31)")
    links = bucket_links(h2, s2, J) if index is None else index
    if links.dtype != torch.int16 or tuple(links.shape) != (D, I) \
            or links.device != dev or not links.is_contiguous():
        raise ValueError(f"index must be contiguous int16 bucket links "
                         f"({D}, {I}) on {dev}")
    B = x.shape[0]
    out = torch.empty((D, B, J), dtype=x.dtype, device=dev)
    if B:
        pl = plan(D, B, I, J, x.element_size(), chunks)
        if pl.blocks // (D // pl.reps) >= 2 ** 31:
            raise ValueError(f"grid out of range for B={B}, I={I}, J={J}")
        part = (torch.empty((pl.chunks, D, B, J), dtype=torch.float32,
                            device=dev) if pl.chunks > 1 else None)
        vec = I % 4 == 0 and _aligned((x, 4 * x.element_size()), (h2, 16),
                                      (links, 8))
        _raise_on(_lib().count_sketch_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), h2.data_ptr(),
            links.data_ptr(), 0 if part is None else part.data_ptr(),
            out.data_ptr(), D, B, I, J, TILE, pl.rows, pl.reps, pl.slab,
            pl.slabs, pl.chunks, pl.tiles_per_chunk, int(vec),
            torch.cuda.current_stream(dev).cuda_stream), "count_sketch")
        count_sketch.launches += 1
    return out[0] if h.ndim == 1 else out


def unsketch(y: torch.Tensor, h: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """y (B, J) or (D, B, J) -> (D, B, I), or (B, I) for 1-D tables and a
    2-D y; see the module docstring."""
    dev = y.device
    h2, s2 = _tables(h, s, dev, "unsketch")
    D, I = h2.shape
    if y.ndim not in (2, 3) or (y.ndim == 3 and y.shape[0] != D):
        raise ValueError(f"y must be (B, J) or ({D}, B, J), got "
                         f"{tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    B, J = y.shape[-2], y.shape[-1]
    if J >= 2 ** 31:
        raise ValueError(f"J={J} must lie below 2^31")
    out = torch.empty((D, B, I), dtype=y.dtype, device=dev)
    if B and I:
        vec = I % 4 == 0 and _aligned((h2, 16), (s2, 16))
        _raise_on(_lib().unsketch_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16),
            B * J if y.ndim == 3 else 0, h2.data_ptr(), s2.data_ptr(),
            out.data_ptr(), D, B, unsketch_rows(D, B, I), I, J, int(vec),
            torch.cuda.current_stream(dev).cuda_stream), "unsketch")
        unsketch.launches += 1
    return out[0] if h.ndim == 1 and y.ndim == 2 else out


count_sketch.launches = 0
unsketch.launches = 0
