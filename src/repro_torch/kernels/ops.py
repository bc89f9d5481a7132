"""Device dispatch for the port's kernels.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU; for CUDA tensors it launches the hand-written kernel or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.sketch_update import sketch_update


def _resolve(use_kernel: Optional[bool], dev: torch.device,
             what: str) -> bool:
    if use_kernel is None:
        return dev.type == "cuda"
    if use_kernel and dev.type != "cuda":
        raise ValueError(f"{what}=True needs CUDA tensors: the CUDA kernel "
                         f"has no CPU or interpret mode")
    return bool(use_kernel)


def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       start: torch.Tensor, fold_base: torch.Tensor,
                       use_kernel: Optional[bool] = None):
    """Flash-decode paged attention statistics (see kernels/ref.py).

    ``use_kernel``: None picks by device (kernel for CUDA tensors, plain
    version for CPU tensors); True demands the kernel and raises on the
    CPU, where a CUDA kernel cannot run; False is an explicit request for
    the plain version on either device."""
    if _resolve(use_kernel, q.device, "paged_kernels"):
        return paged_attention(q, k_pool, v_pool, tables, start, fold_base)
    return ref.paged_attention_ref(q, k_pool, v_pool, tables, start,
                                   fold_base)


def sketch_update_op(pieces: Sequence[Tuple[torch.Tensor, int]],
                     m_table: torch.Tensor, v_table: torch.Tensor,
                     coeffs_m: torch.Tensor, coeffs_v: torch.Tensor, *,
                     b1: float, b2: float,
                     use_kernel: Optional[bool] = None
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Sketched-moment update-retrieve for one leaf given as pieces
    ``(g_piece, offset)`` of one flat vector (kernels/sketch_update.py).
    Updates both (R, C) tables in place, every piece accumulated before
    this returns, and returns an iterator over each piece's f32
    (m_hat, v_hat).  Given one piece ``[(g, 0)]`` it is the reference's
    flat ``sketch_update_op``.  ``use_kernel`` as for
    ``paged_attention_op``, decided by the tables' device."""
    pieces = list(pieces)
    if _resolve(use_kernel, m_table.device, "use_kernel"):
        return sketch_update(pieces, m_table, v_table, coeffs_m, coeffs_v,
                             b1=b1, b2=b2)
    new_m, new_v = ref.sketch_accumulate_ref(pieces, m_table, v_table,
                                             coeffs_m, coeffs_v, b1, b2)
    m_table.copy_(new_m)
    v_table.copy_(new_v)
    return (ref.sketch_retrieve_ref(g.numel(), off, m_table, v_table,
                                    coeffs_m, coeffs_v)
            for g, off in pieces)
