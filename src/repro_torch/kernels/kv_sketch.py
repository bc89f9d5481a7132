"""Wrappers of the Hopper sketched-KV kernels (``csrc/kv_sketch.cu``), the
ports of the TPU kernels ``repro/kernels/kv_sketch.py:tail_fold`` and
``:tail_scores``.

``tail_fold(rows, positions, counts, tail, coeffs)`` folds, for each batch
element g, the first ``counts[g]`` rows of ``rows[g]`` (N, D) at absolute
``positions[g]`` into the (Z, C, D) f32 table ``tail[g]``, in place:
``tail[g, z, h_z(p)] += s_z(p) * row``, bitwise as a row-by-row fold
(``ref.tail_fold_rowwise_ref``) with one block per table, hash row and
slice of ``FOLD_COLS`` columns.  ``tail`` may be a strided view
(the serve path folds one slot's tables out of the stacked per-slot
tensor): its last three axes must be contiguous, its batch stride is free.

``tail_scores(q, tail_k, coeffs, T)`` returns the median-of-rows score
estimates (B, K, N, T) f32 for queries q (B, K, N, hd) f32 against the
key tables tail_k (B, Z, C, K, hd) f32, one kv head's tables for each of
its query rows: ``out[b, k, n, t] = median_z s_z(t) * q[b, k, n] .
tail_k[b, z, h_z(t), k]``.  The bucket products run on the tensor cores
in 3xTF32 (f32-level error), in decode tiles of 16 query rows x 64
buckets when N <= 16 and 64 x 64 tiles otherwise; hd must be a multiple
of 4.

Both check what the kernels take and raise on anything else, allocate
outputs and scratch, launch on the current stream and raise if a launch
was refused.  They take only CUDA tensors; ``kernels/ops.py`` sends CPU
tensors to the plain versions.  ``tail_fold.launches`` counts fold
launches (one per call); ``tail_scores.launches`` counts score launches
(two per call: products, then select).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.sketch.hashing import coeff_bits

MAX_ROWS = 8                # Z instantiated in the select pass
FOLD_COLS = 64              # kFoldCols: table columns per fold block
SELECT_SMEM = 200 * 1024    # kSelSmem: a select block's staged products

_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_sketch")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.tail_fold_launch.argtypes = [
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_ptr, _c_int,
        _c_int, _c_int, _c_ll, _c_int, _c_ptr]
    lib.tail_fold_launch.restype = _c_int
    lib.tail_scores_products_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr] + [_c_int] * 6 + [_c_ptr]
    lib.tail_scores_products_launch.restype = _c_int
    lib.tail_scores_select_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ll, _c_int,
        _c_ptr]
    lib.tail_scores_select_launch.restype = _c_int
    lib._argtypes_set = True
    return lib


def _on(dev: torch.device, what: str, **named: torch.Tensor) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")


def _rows_ok(Z: int, C: int, coeffs: torch.Tensor) -> None:
    if not 1 <= Z <= MAX_ROWS:
        raise ValueError(f"{Z} hash rows; the kernels take 1 to {MAX_ROWS}")
    if not 1 <= C < 2 ** 31:
        raise ValueError(f"{C} columns")
    if tuple(coeffs.shape) != (Z, 4):
        raise ValueError(f"coeffs must be ({Z}, 4), got "
                         f"{tuple(coeffs.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def tail_fold(rows: torch.Tensor, positions: torch.Tensor,
              counts: torch.Tensor, tail: torch.Tensor,
              coeffs: torch.Tensor) -> torch.Tensor:
    """Fold rows (G, N, D) bf16/f32 at positions (G, N) int32, the first
    counts[g] (G,) int32 of each, into tail (G, Z, C, D) f32 in place.
    Returns ``tail``."""
    dev = tail.device
    _on(dev, "tail_fold", rows=rows, positions=positions, counts=counts,
        coeffs=coeffs)
    if rows.ndim != 3 or tail.ndim != 4:
        raise ValueError(f"rows must be (G, N, D) and tail (G, Z, C, D); got "
                         f"{tuple(rows.shape)} / {tuple(tail.shape)}")
    G, N, D = rows.shape
    _, Z, C, _ = tail.shape
    if tail.shape[0] != G or tail.shape[3] != D:
        raise ValueError(f"tail {tuple(tail.shape)} does not match rows "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rows must be bfloat16 or float32, got {rows.dtype}")
    if tail.dtype != torch.float32:
        raise ValueError(f"tail must be float32, got {tail.dtype}")
    if tuple(tail.stride()[1:]) != (C * D, D, 1):
        raise ValueError("tail's (Z, C, D) axes must be contiguous")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    vec = 16 // rows.element_size()             # elements per 16-byte copy
    if D % vec or rows.data_ptr() % 16 or tail.data_ptr() % 16 \
            or tail.stride(0) % 4:
        raise ValueError(f"the fold copies 16 bytes at a time: D ({D}) must "
                         f"be a multiple of {vec}, rows and tail 16-byte "
                         f"aligned and tail's batch stride a multiple of 4")
    for name, t, shape in (("positions", positions, (G, N)),
                           ("counts", counts, (G,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}")
    _rows_ok(Z, C, coeffs)
    if G == 0 or N == 0:
        return tail
    cf = coeff_bits(coeffs)
    err = _lib().tail_fold_launch(
        rows.data_ptr(), int(rows.dtype == torch.bfloat16),
        positions.data_ptr(), counts.data_ptr(), tail.data_ptr(),
        tail.stride(0), cf.data_ptr(), G, N, Z, C, D,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "tail_fold")
    tail_fold.launches += 1
    return tail


def tail_scores(q: torch.Tensor, tail_k: torch.Tensor, coeffs: torch.Tensor,
                T: int) -> torch.Tensor:
    """Median-of-rows score estimates (B, K, N, T) f32; see the module
    docstring."""
    dev = q.device
    _on(dev, "tail_scores", tail_k=tail_k, coeffs=coeffs)
    if q.ndim != 4 or tail_k.ndim != 5:
        raise ValueError(f"q must be (B, K, N, hd) and tail_k (B, Z, C, K, "
                         f"hd); got {tuple(q.shape)} / "
                         f"{tuple(tail_k.shape)}")
    B, K, N, hd = q.shape
    _, Z, C, _, _ = tail_k.shape
    if (tail_k.shape[0], tail_k.shape[3], tail_k.shape[4]) != (B, K, hd):
        raise ValueError(f"tail_k {tuple(tail_k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("tail_k", tail_k)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    _rows_ok(Z, C, coeffs)
    if hd % 4 or q.data_ptr() % 16 or tail_k.data_ptr() % 16:
        raise ValueError(f"the products copy 16 bytes at a time: hd ({hd}) "
                         f"must be a multiple of 4 and q and tail_k 16-byte "
                         f"aligned")
    T = int(T)
    if Z * C * 4 > SELECT_SMEM:
        raise ValueError(f"the select stages a query row's {Z} x {C} "
                         f"products in shared memory: at most "
                         f"{SELECT_SMEM} bytes")
    if B * K * Z > 65535 or -(-N // 8) > 65535 or T < 1:
        raise ValueError(f"grid out of range for B*K*Z={B * K * Z}, N={N}, "
                         f"T={T}")
    out = torch.empty((B, K, N, T), dtype=torch.float32, device=dev)
    if B * K * N == 0:
        return out
    prod = torch.empty((B * K, Z, N, C), dtype=torch.float32, device=dev)
    cf = coeff_bits(coeffs)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.tail_scores_products_launch(
        q.data_ptr(), tail_k.data_ptr(), prod.data_ptr(), B, K, N, Z, C, hd,
        stream), "tail_scores products")
    tail_scores.launches += 1
    _raise_on(lib.tail_scores_select_launch(
        prod.data_ptr(), cf.data_ptr(), out.data_ptr(), B * K, N, Z, C, T,
        stream), "tail_scores select")
    tail_scores.launches += 1
    return out


tail_fold.launches = 0
tail_scores.launches = 0
