"""Cost walk of one step (the counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses compiled HLO and weights while-loop bodies by trip
count.  The port has no HLO: it runs the step once in eager PyTorch,
sharded as DTensors over the dry run's mesh with the tensors on the meta
device, under ``CostMode``, a dispatch mode that sees every aten op of
the rank's *local* shards (it defers DTensor ops to DTensor, whose
local ops then come back to it; the fake-tensor runs of DTensor's
sharding propagation are skipped).  Eager PyTorch runs every layer and
every timestep, so no trip-count weighting is needed, and the recompute
of ``torch.utils.checkpoint`` is counted as it happens.

Cost model (per device, this rank's shards):
  flops            : ``torch.utils.flop_counter``'s formulas (matmuls,
                     bmm, convolutions, attention) at local shapes, and
                     the paged-attention kernel's, which runs on meta
                     tensors as one op of its shapes (kernels/ops.py)
  bytes            : every aten op's input bytes plus output bytes,
                     views and allocations skipped: the instruction-level
                     bound (nothing is fused in eager PyTorch); a gather
                     (index, index_select, gather, embedding) is charged
                     its indices and twice its output, a scatter into a
                     tensor (index_put_, index_add_, scatter*) its
                     indices and twice its values, not the whole tensor
                     (the reference's dynamic-slice / update-slice rule)
  collective bytes : each functional collective's buffer bytes and group
                     size through the reference's ring model
                     (``_collective_traffic``), over NVLink (``ici``) or,
                     for a group that spans pods, the network (``dcn``,
                     the reference's hierarchical model)
  peak bytes       : the arguments plus the most the run holds live at
                     once (storages tracked from allocation to release)

``CommDebugMode`` counts the collectives alongside, as a cross-check of
the walk's own count.  ``CostMode.collectives`` lists each collective
with its group and buffer shapes, and the port's calling function
(``_site``): the record that shows which leaves a step gathers over
which mesh axes.

Roofline constants: the H100 SXM's (NVIDIA datasheet peaks, not
measurements): dense bf16 989 TFLOP/s and 3.35 TB/s HBM3, as
``chip_smoke.py`` bounds its kernels; NVLink 4 at 450 GB/s a direction
(900 GB/s bidirectional) as the intra-pod link, and one 400 Gb/s NDR
InfiniBand port a GPU (50 GB/s) across pods.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ops as _kops  # noqa: F401 (defines the op)

# NVIDIA H100 SXM datasheet peaks
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
ICI_BW = 450e9                  # NVLink 4, bytes/s a direction
DCN_BW = 50e9                   # 400 Gb/s InfiniBand NDR, bytes/s

_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put_", "index_put", "index_add_", "index_add",
             "scatter_", "scatter", "scatter_add_", "scatter_add",
             "_index_put_impl_"}

# ops that allocate nothing worth moving or only alias their input
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd"}


@register_flop_formula(torch.ops.repro_torch.paged_attention)
def _paged_attention_flops(q, k_pool, v_pool, tables, *_, out_shape=None,
                           **__) -> int:
    """The paged-attention kernel's dot flops: q·k and p·v over every
    table entry's keys (dead entries included, as the plain version)."""
    B, Sq, K, R, hd = q
    keys = tables[1] * k_pool[1]
    return 4 * B * K * R * Sq * keys * hd


def _collective_traffic(op: str, out_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if op == "all-gather":
        return out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _group(args) -> Optional[list]:
    """Global ranks of a functional collective's group (its group-name
    argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except (RuntimeError, ValueError, KeyError):
                continue
    return None


def _site() -> str:
    """The innermost frame of the port's own code (file:function)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and "cost_analysis" not in name:
            short = name.split("repro_torch/")[-1]
            return f"{short}:{f.f_code.co_name}"
        f = f.f_back
    return "<other>"


class CostMode(TorchDispatchMode):
    """Counts flops, bytes, collectives and live bytes of the local ops a
    step runs (module docstring).  ``pod_size``: ranks in a pod (groups
    spanning several count as network traffic).  ``sites``: also
    aggregate by aten op and by the port's calling function, for
    ``cost_debug.attribute``."""

    def __init__(self, pod_size: int = 256, sites: bool = False):
        super().__init__()
        self.pod_size = pod_size
        self.sites = sites
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ici_bytes = 0.0
        self.dcn_bytes = 0.0
        self.per_op: Dict[str, float] = defaultdict(float)
        # (op, group ranks, input shapes, output shapes, calling site)
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self.by_op: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self.by_site: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))

    # -- live bytes --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        if any(_is_fake(t) for t in flat_in + flat_out):
            return out          # DTensor's shape propagation, not the step
        name = func._overloadpacket.__name__
        rec = {}
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            ranks = _group(args) or []
            g = len(ranks)
            ob = sum(_nbytes(o) for o in flat_out)
            traffic = _collective_traffic(coll, ob, g)
            self.ici_bytes += traffic
            pods = len({r // self.pod_size for r in ranks}) if g > 1 else 1
            if pods > 1:
                L = max(1, g // pods)
                self.dcn_bytes += 2.0 * ob * (pods - 1) / pods / L
            self.per_op[coll] += traffic
            self.per_op[coll + "_count"] += 1
            self.collectives.append((coll, tuple(ranks),
                                     [tuple(t.shape) for t in flat_in],
                                     [tuple(t.shape) for t in flat_out],
                                     _site()))
            rec["coll"] = traffic
        elif not (func.is_view or name in _NO_BYTES):
            from torch.utils.flop_counter import flop_registry
            pk = func._overloadpacket
            if pk in flop_registry:
                f = float(flop_registry[pk](*args, **kwargs, out_val=out))
                self.flops += f
                rec["flops"] = f
            if name in _GATHERS:
                b = sum(_nbytes(t) for t in flat_in[1:]) + 2 * sum(
                    _nbytes(t) for t in flat_out)
            elif name in _SCATTERS:
                b = sum(_nbytes(t) for t in flat_in[1:]) + sum(
                    _nbytes(t) for t in flat_in[-1:])
            else:
                b = sum(_nbytes(t) for t in flat_in + flat_out)
            self.hbm_bytes += b
            rec["bytes"] = b
        if not func.is_view:          # in-place results are their inputs
            held = {id(t.untyped_storage()) for t in flat_in}
            for o in flat_out:
                if id(o.untyped_storage()) not in held:
                    self._track(o)
        if self.sites and rec:
            site = _site()
            for k, v in rec.items():
                self.by_op[name][k] += v
                self.by_site[site][k] += v
        return out

    def totals(self) -> Dict[str, float]:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes,
                "per_op": dict(self.per_op)}


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   coll: Dict[str, float], *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW, ici_bw: float = ICI_BW,
                   dcn_bw: float = DCN_BW) -> Dict[str, float]:
    """The reference's roofline terms, at the H100 SXM's peaks unless the
    rates are given."""
    t_compute = flops_per_device / peak_flops
    t_memory = hbm_bytes_per_device / hbm_bw
    t_ici = coll.get("ici_bytes", 0.0) / ici_bw
    t_dcn = coll.get("dcn_bytes", 0.0) / dcn_bw
    t_coll = t_ici + t_dcn
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_ici_s": t_ici,
        "t_dcn_s": t_dcn,
        "dominant": dom,
        "step_lower_bound_s": bound,
        "compute_roofline_fraction": t_compute / bound if bound else 0.0,
    }
