"""Which operations of a training step add floats in an order the card
does not fix.

A resumed run continues bit for bit only if every float sum of a step
adds in an order that depends on the shapes and the data alone.  On the
card three kinds of operation break that:

* an add into a target that several terms share, made with atomics:
  ``index_add``, ``scatter_add``, ``scatter_reduce`` (sum, mean, prod),
  ``index_reduce``, an accumulating ``put_`` — the backward of a gather,
  an ``index_select`` or an embedding bag lands here.  Where every target
  receives one term the order cannot matter, so the data decides;
* a floating ``cumsum`` over a tensor whose scanned dim holds every
  element: CUB's device-wide scan, whose look-back varies from run to run
  (a scan over one dim of a larger tensor is a fixed loop per column);
* operations PyTorch documents as nondeterministic on CUDA with no other
  path (``NONDETERMINISTIC``).

An accumulating ``index_put_`` (the backward of advanced indexing) is not
flagged: on the card it sorts the targets stably and sums each target's
run with a fixed reduction, no atomics.  Nor are integer adds, which are
exact in any order.

``OrderAudit`` is a dispatch mode that records every aten operation run
under it, the backward's included, and keeps those of the kinds above
(``flagged``).  Collisions are a property of the data, so a run on the
CPU at a reduced size shows which of the card's adds would vary; the
card's own run is ``tools/determinism_audit.py``.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# documented as nondeterministic on CUDA (``torch.use_deterministic_
# algorithms``) with no deterministic path
NONDETERMINISTIC = (
    "avg_pool3d_backward", "adaptive_avg_pool2d_backward",
    "_adaptive_avg_pool2d_backward", "adaptive_avg_pool3d_backward",
    "_adaptive_avg_pool3d_backward", "adaptive_max_pool2d_backward",
    "fractional_max_pool2d_backward", "fractional_max_pool3d_backward",
    "max_unpool2d", "max_unpool3d", "upsample_linear1d_backward",
    "upsample_bilinear2d_backward", "upsample_bicubic2d_backward",
    "upsample_trilinear3d_backward", "reflection_pad1d_backward",
    "reflection_pad2d_backward", "reflection_pad3d_backward",
    "nll_loss_forward", "nll_loss2d_forward", "_ctc_loss_backward",
    "_embedding_bag_backward", "histc", "bincount", "kthvalue",
    "grid_sampler_2d_backward", "grid_sampler_3d_backward",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward",
    "_efficient_attention_backward", "_flash_attention_backward")

_INDEX_ADDS = ("index_add", "index_add_", "index_reduce", "index_reduce_")
_SCATTER_ADDS = ("scatter_add", "scatter_add_", "scatter_reduce",
                 "scatter_reduce_")


def _targets(shape, dim: int, index: torch.Tensor) -> torch.Tensor:
    """The flat target of every element of a scatter's ``index`` into a
    tensor of ``shape`` along ``dim``."""
    strides = [1] * len(shape)
    for k in range(len(shape) - 2, -1, -1):
        strides[k] = strides[k + 1] * shape[k + 1]
    lin = index.long() * strides[dim]
    for k in range(index.ndim):
        if k != dim:
            view = [1] * index.ndim
            view[k] = -1
            lin = lin + torch.arange(index.shape[k], device=index.device
                                     ).view(view) * strides[k]
    return lin.reshape(-1)


def _collide(flat: torch.Tensor) -> bool:
    return flat.numel() > 1 and int(torch.unique(flat).numel()) < \
        flat.numel()


def varying_order(name: str, args, kwargs) -> str:
    """Why operation ``name`` (its overload packet's name) on these
    arguments adds in a varying order on the card, or '' if it does not."""
    if name in NONDETERMINISTIC:
        return "no deterministic CUDA path"
    if name in _INDEX_ADDS:
        self, dim, index = args[0], args[1], args[2]
        if self.is_floating_point() and _collide(index.reshape(-1)):
            return "float adds into shared targets (atomics)"
        return ""
    if name in _SCATTER_ADDS:
        self, dim, index = args[0], args[1], args[2]
        if name.startswith("scatter_reduce"):
            reduce = args[4] if len(args) > 4 else kwargs.get("reduce")
            if reduce in ("amax", "amin"):
                return ""
        dim = dim % max(self.ndim, 1)
        if self.is_floating_point() and _collide(
                _targets(tuple(self.shape), dim, index)):
            return "float adds into shared targets (atomics)"
        return ""
    if name == "put_":
        self, index = args[0], args[1]
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if acc and self.is_floating_point() and _collide(index.reshape(-1)):
            return "float adds into shared targets (atomics)"
        return ""
    if name == "cumsum":
        self, dim = args[0], args[1]
        if self.is_floating_point() and self.numel() > 1 \
                and self.numel() == self.shape[dim]:
            return "a device-wide float scan (CUB look-back)"
    return ""


class OrderAudit(TorchDispatchMode):
    """Records every aten operation run under it (``counts``, by name)
    and each one that adds floats in a varying order on the card
    (``flagged``: (name, reason, shape of the first argument))."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.flagged: List[Tuple[str, str, Tuple[int, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.counts[name] += 1
        why = varying_order(name, args, kwargs)
        if why:
            first = args[0] if args else None
            self.flagged.append((name, why, tuple(getattr(first, "shape",
                                                          ()))))
        return func(*args, **kwargs)

    def summary(self) -> Dict[str, int]:
        """{name: times flagged}."""
        return dict(Counter(n for n, _, _ in self.flagged))
