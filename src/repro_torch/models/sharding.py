"""Logical-axis sharding of the port (``repro/models/sharding.py``).

Model code names the logical axes of an activation with ``shard(x,
"batch", "seq", "heads", None)``.  A rules dict (logical name -> mesh
axis, tuple of mesh axes, or None) is installed with ``logical_rules``
around a step; outside any rules context ``shard`` does nothing, so the
same model code runs unsharded.  The rule sets ``train_rules`` and
``decode_rules`` are plain-Python copies of the reference's, equal to
them dict for dict.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of axis names.  ``norm_spec`` writes a one-axis tuple as its
name, as jax 0.9 compares ``PartitionSpec`` entries (``P(None,
("data",))[1] == "data"``).  ``placements`` turns a spec into DTensor
placements on a ``DeviceMesh``: ``Shard(d)`` on every mesh dim that
names tensor dim d, ``Replicate()`` elsewhere.  A tensor dim sharded
over two axes, ("data", "model"), is split major to minor in the mesh's
dim order, as in JAX (the rules only name axes in that order).

``shard`` is the counterpart of ``with_sharding_constraint``: on a
DTensor inside a rules context it ``redistribute``s to the spec's
placements (uneven dims are fine: DTensor splits as ``torch.chunk``);
on a plain tensor it does nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_CTX = threading.local()


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_CTX, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Optional[Dict[str, MeshAxes]]):
    old = current_rules()
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = old


def norm_entry(entry: MeshAxes) -> MeshAxes:
    """A one-axis tuple as its name; an empty tuple as None."""
    if isinstance(entry, (tuple, list)):
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
        return tuple(entry)
    return entry


def norm_spec(spec: Sequence[MeshAxes]) -> Spec:
    return tuple(norm_entry(e) for e in spec)


def spec_for(axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    rules = rules if rules is not None else (current_rules() or {})
    return norm_spec(rules.get(a) if a is not None else None for a in axes)


def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[MeshAxes], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``).  Mesh axes the spec names must exist on the
    mesh and appear, within one entry, in the mesh's order.  A mesh dim
    of one device splits nothing: it is ``Replicate()`` whatever the
    spec names (so a one-device mesh runs every op unsplit)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def axes_size(entry: MeshAxes, sizes: Dict[str, int]) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= sizes[a]
    return n


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` so logical axis i is sharded per the active rules:
    a DTensor is redistributed to the spec's placements; anything else
    is returned as it is."""
    rules = current_rules()
    if not rules:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    assert len(axes) == x.ndim, (axes, tuple(x.shape))
    want = placements(spec_for(axes, rules), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_local(x: torch.Tensor, spec: Sequence[MeshAxes]) -> torch.Tensor:
    """A DTensor's shard after redistributing it to ``spec`` (a
    differentiable ``redistribute`` + ``to_local``); a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local()


def placed(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """The DTensor on ``mesh`` whose shard on this rank is ``x``, with the
    placements ``pl`` (every split even)."""
    from torch.distributed.tensor import DTensor, Shard
    shape = list(x.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.shape[i]
    return DTensor.from_local(x, mesh, tuple(pl), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def from_local(x: torch.Tensor, mesh, spec: Sequence[MeshAxes],
               partial: Sequence[str] = (), reduce: str = "sum"
               ) -> torch.Tensor:
    """``placed`` with the placements of ``spec``; mesh axes in
    ``partial`` hold ``Partial(reduce)`` terms ("sum", "max")."""
    from torch.distributed.tensor import Partial
    pl = list(placements(spec, mesh))
    for a in partial:
        pl[list(mesh.mesh_dim_names).index(a)] = Partial(reduce)
    return placed(x, mesh, pl)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate()`` on every mesh dim (its
    partial terms reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def gathered(w: torch.Tensor, rows) -> torch.Tensor:
    """A weight ``w`` gathered whole as this rank's local tensor, for a
    computation on rows split as the placements ``rows``: its gradient
    comes back ``Partial`` (summed) over the mesh dims that split the
    rows and replicated over the others.  A plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Partial, Replicate, Shard
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    return replicate(w).to_local(grad_placements=grad)


def local_sum_mean(total: torch.Tensor, count: int, mesh, rows
                   ) -> torch.Tensor:
    """The global mean of a quantity whose local sum over this rank's
    rows (split as the placements ``rows``) is ``total`` and whose global
    count is ``count``: a ``Partial`` (summed) scalar DTensor of the local
    term total / count."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return placed(total / count, mesh, tuple(
        Partial() if isinstance(p, Shard) else Replicate() for p in rows))


def single_device_mesh(*trees):
    """The mesh of the first DTensor among ``trees`` (nested dicts, lists
    and tuples) if that mesh has one device, else None."""
    def first(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            for v in node:
                m = first(v)
                if m is not None:
                    return m
            return None
        return node.device_mesh if is_dtensor(node) else None
    mesh = first(list(trees))
    return mesh if mesh is not None and mesh.size() == 1 else None


def unwrap(tree):
    """Every DTensor of ``tree`` as its local tensor (nested dicts, lists
    and tuples; other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: unwrap(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unwrap(v) for v in tree)
    return tree.to_local() if is_dtensor(tree) else tree


def rewrap(tree, mesh):
    """Every tensor of ``tree`` as a replicated DTensor on the one-device
    ``mesh`` (where the local tensor is the whole tensor)."""
    if isinstance(tree, dict):
        return {k: rewrap(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rewrap(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor):
        return from_local(tree, mesh, (None,) * tree.ndim)
    return tree


# ---------------------------------------------------------------------------
# Canonical rule sets for the production mesh (the reference's, verbatim).
# ---------------------------------------------------------------------------


def train_rules(multi_pod: bool, strategy: str = "fsdp_seq",
                expert_parallel: bool = False) -> Dict[str, MeshAxes]:
    """Activation rules for train / prefill.

    fsdp_seq   : batch over (pod,)data + context sharding of seq over
                 model; params FSDP-sharded (launch/shardings.py).  SSD
                 runs its chunk recurrence as a two-level scan over the
                 ``ctx_shards`` context shards (models/ssm.py).
    fsdp_batch : batch over (data, model), one sequence per device;
                 params FSDP-sharded (xLSTM single-pod).
    tp         : batch over (pod,)data + inner-dim tensor parallelism
                 over model (xLSTM multi-pod / prefill).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    base = {
        "batch": dp, "seq": None, "residual": None, "kv_seq": None,
        "kv_blocks": None,
        "heads": None, "kv_heads": None, "embed": None, "ff": None,
        "vocab": None, "experts": "model" if expert_parallel else None,
        "expert_cap": None, "ssm_inner": None, "ssm_heads": None,
        "state": None, "zero": "data",
        # MoE dispatch groups: over every data-parallel axis; also over
        # "model" under FSDP strategies without expert parallelism
        "moe_groups": dp,
    }
    base["chunks"] = None
    base["ctx_shards"] = 1
    if strategy.startswith("fsdp") and not expert_parallel:
        base["moe_groups"] = dp + ("model",)
    if strategy == "fsdp_seq":
        base.update({"seq": "model", "residual": "model", "chunks": "model",
                     "ctx_shards": 16})
    elif strategy == "fsdp_batch":
        base.update({"batch": ("data", "model")})
    elif strategy == "tp":
        base.update({"ssm_inner": "model", "ssm_heads": "model",
                     "ff": "model", "vocab": "model",
                     "heads": "model"})
    else:
        raise ValueError(strategy)
    return base


def decode_rules(multi_pod: bool, long_context: bool) -> Dict[str, MeshAxes]:
    """Decode: weight-stationary TP over model plus the KV split along
    its sequence (the paged pool: its block axis; split-KV)."""
    r = train_rules(multi_pod, strategy="tp")
    r["heads"] = None
    r["residual"] = None  # decode S=1
    if long_context:
        # batch == 1: shard the KV / block dim over data AND model
        r["batch"] = None
        r["kv_seq"] = ("data", "model")
        r["kv_blocks"] = ("data", "model")
    else:
        r["kv_seq"] = "model"
        r["kv_blocks"] = "model"
    return r
