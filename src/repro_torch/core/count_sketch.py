"""Count Sketch (Charikar et al. 2002), Definition 1 (the port of
``repro/core/count_sketch.py``).

CS(x; h, s)_j = sum_{h(i)=j} s(i) x(i): a signed random projection.  Every
apply goes through ``kernels/ops.py:count_sketch_op`` (the Hopper
``count_sketch`` kernel for CUDA tensors, its plain version for CPU
tensors) and every decompress lookup through ``unsketch_op``, with all D
repetitions in one call.  ``use_kernel`` is passed through to the op.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.estimators import median_combine
from repro_torch.core.hashes import ModeHash
from repro_torch.kernels.ops import count_sketch_op, unsketch_op


def cs_apply_batch(X: torch.Tensor, mh: ModeHash,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Row-batched CS: X (..., I) -> (D, ..., J).  Duplicate buckets add,
    as the reference's one-hot matmul adds them."""
    lead = X.shape[:-1]
    out = count_sketch_op(X.reshape(-1, X.shape[-1]).contiguous(), mh.h,
                          mh.s, mh.J, mh.index, use_kernel)
    return out.reshape((mh.D,) + tuple(lead) + (mh.J,))


def cs_apply(x: torch.Tensor, mh: ModeHash,
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x: (I,) -> (D, J)."""
    return cs_apply_batch(x, mh, use_kernel)


def cs_apply_cols(X: torch.Tensor, mh: ModeHash,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Column-wise CS of a matrix: X (I, R) -> (D, J, R)."""
    return cs_apply_batch(X.T, mh, use_kernel).transpose(1, 2)


def cs_unsketch(y: torch.Tensor, mh: ModeHash,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Decompress: x_hat(i) = median_d s_d(i) y_d[h_d(i)].  y: (D, J) ->
    (I,)."""
    est = unsketch_op(y[:, None, :].contiguous(), mh.h, mh.s, use_kernel)
    return median_combine(est[:, 0])


def cs_unsketch_at(y: torch.Tensor, mh: ModeHash, idx: torch.Tensor,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Decompress the selected indices only."""
    est = unsketch_op(y[:, None, :].contiguous(),
                      mh.h[:, idx].contiguous(), mh.s[:, idx].contiguous(),
                      use_kernel)
    return median_combine(est[:, 0])
