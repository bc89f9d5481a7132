"""Wrappers of the Hopper count-sketch kernels (``csrc/count_sketch.cu``),
the ports of the TPU kernels ``repro/kernels/count_sketch.py:count_sketch``
and ``repro/kernels/unsketch.py:unsketch``.

Both take D stacked hash rows ``h`` (D, I) int32 and ``s`` (D, I) f32 and
do every repetition in one launch; a 1-D table (I,) is the reference's
call (D = 1, no leading axis in the result).

``count_sketch(x, h, s, J, index=None)``: x (B, I) f32 or bf16 ->
(D, B, J) in x's type, ``out[d, b, j] = sum_{h_d(i) = j} s_d(i) x[b, i]``
accumulated in f32.  The kernel buckets through the hash's inverse index
``(perm, offsets)`` (``inverse_index``), which belongs to the hash and is
built once with it (``core/hashes.py:ModeHash``); a bare ``(h, s)`` call
builds it here.  Tables hold 0 <= h < J (the port's ``ModeHash``
guarantees it; the wrapper does not sync to check); an entry with h >= J
contributes nothing, as in the TPU kernel.

``unsketch(y, h, s)``: y (B, J) shared by every repetition, or (D, B, J)
-> (D, B, I) in y's type, ``out[d, b, i] = s_d(i) * y[d, b, h_d(i)]``,
bitwise the plain version.  An entry with h outside [0, J) reads 0, as
the Pallas kernel's one-hot does, where ``jnp`` indexing would clamp and
the plain version raises; no table of the port is out of range, so no
path sees the difference.

Both check what the kernels take and raise on anything else, allocate
the output, launch on the current stream and raise if a launch was
refused.  They take only CUDA tensors; ``kernels/ops.py`` sends CPU
tensors to the plain versions.  ``count_sketch.launches`` and
``unsketch.launches`` count launches (one per call).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

Index = Tuple[torch.Tensor, torch.Tensor]      # perm (D, I), offsets (D, J+1)


def _lib() -> ctypes.CDLL:
    lib = build.load("count_sketch")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.count_sketch_launch.argtypes = [
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_ll, _c_int, _c_ptr]
    lib.count_sketch_launch.restype = _c_int
    lib.unsketch_launch.argtypes = [
        _c_ptr, _c_int, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_ll, _c_int, _c_ptr]
    lib.unsketch_launch.restype = _c_int
    lib._argtypes_set = True
    return lib


def inverse_index(h: torch.Tensor, J: int) -> Index:
    """The bucket lists of each hash row, on h's device: ``perm`` (D, I)
    int32, the stable sort of the row (so increasing i inside a bucket),
    and ``offsets`` (D, J + 1) int32, bucket j holding
    ``perm[d, offsets[d, j]:offsets[d, j + 1]]``.  Entries outside
    [0, J) fall outside every bucket."""
    h2 = h.reshape(-1, h.shape[-1])
    srt, perm = torch.sort(h2, dim=-1, stable=True)
    edges = torch.arange(J + 1, dtype=srt.dtype, device=h.device)
    offsets = torch.searchsorted(srt, edges.expand(h2.shape[0], J + 1)
                                 .contiguous())
    return perm.to(torch.int32), offsets.to(torch.int32)


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


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def count_sketch(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor, J: int,
                 index: Optional[Index] = None) -> torch.Tensor:
    """x (B, I) -> (D, B, J), or (B, J) for 1-D tables; see the module
    docstring.  ``index`` is ``inverse_index(h, J)``, built here when not
    given."""
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
    B = x.shape[0]
    if not 1 <= J < 2 ** 31 or -(-B // 4) > 65535:
        raise ValueError(f"grid out of range for B={B}, J={J}")
    perm, offsets = inverse_index(h2, J) if index is None else index
    if (perm.dtype, offsets.dtype) != (torch.int32, torch.int32) \
            or tuple(perm.shape) != (D, I) \
            or tuple(offsets.shape) != (D, J + 1) \
            or perm.device != dev or offsets.device != dev \
            or not (perm.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f"index must be contiguous int32 perm ({D}, {I}) "
                         f"and offsets ({D}, {J + 1}) on {dev}")
    out = torch.empty((D, B, J), dtype=x.dtype, device=dev)
    if B:                       # I == 0 leaves every bucket empty: zeros
        _raise_on(_lib().count_sketch_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), perm.data_ptr(),
            offsets.data_ptr(), s2.data_ptr(), out.data_ptr(), D, B, I, J,
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
    if B > 65535 or J >= 2 ** 31 or -(-I // 256) >= 2 ** 31:
        raise ValueError(f"grid out of range for B={B}, J={J}, I={I}")
    out = torch.empty((D, B, I), dtype=y.dtype, device=dev)
    if B and I:
        _raise_on(_lib().unsketch_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16),
            B * J if y.ndim == 3 else 0, h2.data_ptr(), s2.data_ptr(),
            out.data_ptr(), D, B, I, J,
            torch.cuda.current_stream(dev).cuda_stream), "unsketch")
        unsketch.launches += 1
    return out[0] if h.ndim == 1 and y.ndim == 2 else out


count_sketch.launches = 0
unsketch.launches = 0
