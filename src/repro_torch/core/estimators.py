"""Median-of-D combination (the port of ``repro/core/estimators.py``): the
paper computes D independent sketches and returns the median, backed by
Cor. 1's Chebyshev argument.  The median is numpy's (the mean of the
middle pair for an even D), as ``jnp.median`` computes it; ``torch.median``
would return the lower one."""
from __future__ import annotations

import torch

from repro_torch.sketch.csvec import median_rows


def median_combine(estimates: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Median over the D axis of per-repetition estimates."""
    return median_rows(estimates.movedim(axis, 0))


def mean_combine(estimates: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return estimates.mean(dim=axis)
