"""Wrapper of the Hopper paged-attention kernel
(``csrc/paged_attention.cu``), the port of the TPU kernel
``repro/kernels/paged_attention.py:paged_attention``.

Same interface as the reference: q (B, Sq, K, R, hd) bf16, pools
(NB, bs, K, hd) bf16, tables (B, nb) int32 (entries >= NB are dead),
start / fold_base (B,) int32 -> f32 (m, l, acc) shaped (B, K, R, Sq),
(B, K, R, Sq) and (B, K, R, Sq, hd).  The wrapper checks what the kernel
takes and raises on anything else, allocates the outputs, launches on
the current stream and raises if the launch was refused.  It takes only
CUDA tensors; ``kernels/ops.py`` sends CPU tensors to the plain version.
``paged_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256          # kMaxLaneDims * 32 in the kernel
MAX_SMEM_BYTES = 232_448    # opt-in shared memory per block on sm_90

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.paged_attention_launch.argtypes = (
        [_c_ptr] * 9 + [_c_int] * 8 + [ctypes.c_float, _c_ptr])
    lib.paged_attention_launch.restype = _c_int
    lib.paged_attention_smem_bytes.argtypes = [_c_int, _c_int]
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
        if not t.is_contiguous():
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
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(hd, bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block size {bs} x head dim {hd} needs {smem} B "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    # (B, K, R*Sq, hd): each kv head's query rows contiguous, as the
    # reference lays them out for its kernel
    qt = q.permute(0, 2, 3, 1, 4).reshape(B, K, NQ, hd).contiguous()
    m = torch.empty((B, K, NQ), dtype=torch.float32, device=q.device)
    l = torch.empty((B, K, NQ), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, K, NQ, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        qt.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), start.data_ptr(), fold_base.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, NQ, Sq, K, hd, NB,
        bs, nb, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error "
                           f"{err}")
    paged_attention.launches += 1
    return (m.view(B, K, R, Sq), l.view(B, K, R, Sq),
            acc.view(B, K, R, Sq, hd))


paged_attention.launches = 0
