"""Wrapper of the Hopper sketched-moment kernel (``csrc/sketch_update.cu``),
the port of the TPU kernel ``repro/kernels/sketch_update.py:
sketch_update``.

One call updates one leaf's (R, C) f32 moment tables in place and
estimates the leaf's moments:

  new_m = b1 * m + (1-b1) * CS(g),  new_v = b2 * v + (1-b2) * CMS(g^2),
  m_hat = median-of-rows of new_m,  v_hat = min-of-rows of new_v,

where g is one flat vector given as pieces ``(g_piece, offset)``: element
j of a piece is coordinate ``offset + j``.  The tables are scaled and
every piece accumulated before the call returns; the returned iterator
then yields each piece's (m_hat, v_hat), f32 of the piece's numel, one at
a time, so a caller can apply and free one piece's estimates before the
next is made (a yi-9b FFN leaf's estimates for all 48 layers would take
17 GB).  Each table is read from the updated state, so the estimates do
not depend on when the iterator is consumed, as long as the tables are
not changed in between.

The wrapper checks what the kernels take and raises on anything else,
allocates the outputs, launches on the current stream and raises if a
launch was refused.  It takes only CUDA tensors; ``kernels/ops.py``
sends CPU tensors to the plain version.  ``sketch_update.launches``
counts kernel launches: one scale, then one accumulate and one retrieve
per piece.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Sequence, Tuple

import torch

from repro_torch.kernels import build

_c_int, _c_ll, _c_ptr, _c_float = (ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_float)

MAX_ROWS = 8                # kMaxRows in the kernel

Piece = Tuple[torch.Tensor, int]


def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_update")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.sketch_update_scale_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ll, _c_float, _c_float, _c_ptr]
    lib.sketch_update_scale_launch.restype = _c_int
    lib.sketch_update_accumulate_launch.argtypes = [
        _c_ptr, _c_int, _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        _c_int, _c_ll, _c_float, _c_float, _c_ptr]
    lib.sketch_update_accumulate_launch.restype = _c_int
    lib.sketch_update_retrieve_launch.argtypes = [
        _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll,
        _c_ptr, _c_ptr, _c_ptr]
    lib.sketch_update_retrieve_launch.restype = _c_int
    lib._argtypes_set = True
    return lib


def _u32_bits(c: torch.Tensor) -> torch.Tensor:
    """(R, 4) uint32 coefficients, held as int64 values in [0, 2^32) or
    as int32 bits, -> contiguous int32 with the same 32 bits."""
    if c.dtype == torch.int32:
        return c.contiguous()
    if c.dtype != torch.int64:
        raise ValueError(f"coefficients must be int64 or int32, got "
                         f"{c.dtype}")
    return torch.where(c >= 2 ** 31, c - 2 ** 32, c).to(
        torch.int32).contiguous()


def _check(pieces: Sequence[Piece], m_table, v_table, coeffs_m,
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
    if not 1 <= C < 2 ** 32:
        raise ValueError(f"{C} columns; buckets are uint32")
    for name, c in (("coeffs_m", coeffs_m), ("coeffs_v", coeffs_v)):
        if c.device != dev or tuple(c.shape) != (R, 4):
            raise ValueError(f"{name} must be ({R}, 4) on {dev}, got "
                             f"{tuple(c.shape)} on {c.device}")
    for g, offset in pieces:
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


def sketch_update(pieces: Sequence[Piece], m_table: torch.Tensor,
                  v_table: torch.Tensor, coeffs_m: torch.Tensor,
                  coeffs_v: torch.Tensor, *, b1: float, b2: float
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Update the tables in place and return an iterator over each
    piece's (m_hat, v_hat) (see the module docstring)."""
    pieces = [(g, int(off)) for g, off in pieces]
    _check(pieces, m_table, v_table, coeffs_m, coeffs_v)
    lib = _lib()
    R, C = m_table.shape
    cm, cv = _u32_bits(coeffs_m), _u32_bits(coeffs_v)
    stream = torch.cuda.current_stream(m_table.device).cuda_stream

    def launched(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"sketch_update {what} launch failed: CUDA "
                               f"error {err}")
        sketch_update.launches += 1

    launched(lib.sketch_update_scale_launch(
        m_table.data_ptr(), v_table.data_ptr(), R * C, b1, b2, stream),
        "scale")
    for g, offset in pieces:
        launched(lib.sketch_update_accumulate_launch(
            g.data_ptr(), int(g.dtype == torch.bfloat16), g.numel(), offset,
            m_table.data_ptr(), v_table.data_ptr(), cm.data_ptr(),
            cv.data_ptr(), R, C, 1.0 - b1, 1.0 - b2, stream), "accumulate")

    def estimates():
        for g, offset in pieces:
            n = g.numel()
            m_hat = torch.empty(n, dtype=torch.float32, device=g.device)
            v_hat = torch.empty(n, dtype=torch.float32, device=g.device)
            launched(lib.sketch_update_retrieve_launch(
                n, offset, m_table.data_ptr(), v_table.data_ptr(),
                cm.data_ptr(), cv.data_ptr(), R, C, m_hat.data_ptr(),
                v_hat.data_ptr(), stream), "retrieve")
            yield m_hat, v_hat
            del m_hat, v_hat        # the caller's references free them

    return estimates()


sketch_update.launches = 0
