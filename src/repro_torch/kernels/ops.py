"""Device dispatch for the port's kernels.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU; for CUDA tensors it launches the hand-written kernel or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention


def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       start: torch.Tensor, fold_base: torch.Tensor,
                       use_kernel: Optional[bool] = None):
    """Flash-decode paged attention statistics (see kernels/ref.py).

    ``use_kernel``: None picks by device (kernel for CUDA tensors, plain
    version for CPU tensors); True demands the kernel and raises on the
    CPU, where a CUDA kernel cannot run; False is an explicit request for
    the plain version on either device."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        if q.device.type != "cuda":
            raise ValueError("paged_kernels=True needs CUDA tensors: the "
                             "CUDA kernel has no CPU or interpret mode")
        return paged_attention(q, k_pool, v_pool, tables, start, fold_base)
    return ref.paged_attention_ref(q, k_pool, v_pool, tables, start,
                                   fold_base)
