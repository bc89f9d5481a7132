"""Device dispatch for the port's kernels.

A wrapper takes its plain version only because the tensors it was given
lie on the CPU; for CUDA tensors it launches the hand-written kernel or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.count_sketch import Index, count_sketch, unsketch
from repro_torch.kernels.kv_sketch import tail_fold, tail_scores
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.sketch_update import sketch_apply, sketch_update


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


def sketch_apply_op(pieces: Sequence[Tuple[torch.Tensor, int]],
                    params: Sequence[torch.Tensor], m_table: torch.Tensor,
                    v_table: torch.Tensor, coeffs_m: torch.Tensor,
                    coeffs_v: torch.Tensor, *, b1: float, b2: float,
                    lr: float, eps: float, weight_decay: float, bc1: float,
                    bc2: float, use_kernel: Optional[bool] = None) -> None:
    """The fused form of ``sketch_update_op``: updates both tables, then
    takes the AdamW step of each param piece (``params[k]`` for
    ``pieces[k]``) from its estimates, all in place
    (kernels/sketch_update.py:sketch_apply; plain version
    ``ref.sketch_apply_ref``).  ``use_kernel`` as for
    ``paged_attention_op``, decided by the tables' device."""
    kw = dict(b1=b1, b2=b2, lr=lr, eps=eps, weight_decay=weight_decay,
              bc1=bc1, bc2=bc2)
    if _resolve(use_kernel, m_table.device, "use_kernel"):
        sketch_apply(pieces, params, m_table, v_table, coeffs_m, coeffs_v,
                     **kw)
    else:
        ref.sketch_apply_ref(pieces, params, m_table, v_table, coeffs_m,
                             coeffs_v, **kw)


def tail_fold_op(rows: torch.Tensor, positions: torch.Tensor,
                 counts: torch.Tensor, tail: torch.Tensor,
                 coeffs: torch.Tensor,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fold the first ``counts[g]`` rows of each ``rows[g]`` into the
    tables ``tail[g]``, in place (kernels/kv_sketch.py:tail_fold).
    ``use_kernel`` as for ``paged_attention_op``, decided by the tables'
    device."""
    if _resolve(use_kernel, tail.device, "use_kernel"):
        return tail_fold(rows, positions, counts, tail, coeffs)
    return ref.tail_fold_ref(rows, positions, counts, tail, coeffs)


def tail_scores_op(q: torch.Tensor, tail_k: torch.Tensor,
                   coeffs: torch.Tensor, T: int,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Median-of-rows tail score estimates (B, K, N, T) for queries
    (B, K, N, hd) against key tables (B, Z, C, K, hd)
    (kernels/kv_sketch.py:tail_scores).  ``use_kernel`` as for
    ``paged_attention_op``."""
    if _resolve(use_kernel, q.device, "use_kernel"):
        return tail_scores(q, tail_k, coeffs, T)
    return ref.tail_scores_ref(q, tail_k, coeffs, T)


def count_sketch_op(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
                    J: int, index: Optional[Index] = None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Count sketch of the rows of x (B, I) under D stacked hash rows
    (h, s) (D, I) -> (D, B, J), or (B, J) for 1-D tables
    (kernels/count_sketch.py).  ``index`` is the hash's bucket links,
    which only the kernel reads.  ``use_kernel`` as for
    ``paged_attention_op``."""
    if _resolve(use_kernel, x.device, "use_kernel"):
        return count_sketch(x, h, s, J, index)
    return ref.count_sketch_ref(x, h, s, J)


def unsketch_op(y: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Signed lookup ``s_d(i) * y[d, b, h_d(i)]`` of y (B, J) or
    (D, B, J) -> (D, B, I), or (B, I) for 1-D tables and a 2-D y
    (kernels/count_sketch.py:unsketch).  ``use_kernel`` as for
    ``paged_attention_op``."""
    if _resolve(use_kernel, y.device, "use_kernel"):
        return unsketch(y, h, s)
    return ref.unsketch_ref(y, h, s)
