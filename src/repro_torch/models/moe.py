"""GShard-style grouped top-k MoE with capacity, shared experts and the
load-balance aux loss (the reference's ``repro/models/moe.py``).

Tokens are routed in groups of g = min(group_size, T) (T = B*S, zero rows
appended to a whole number of groups) and every expert takes at most C =
``capacity(cfg)`` (token, choice) pairs a group.  C follows from
``group_size``, not from g, so a decode step of a few rows runs each
expert at the same C rows as a full group.  A token's choices queue
k-major: every token's first choice is placed ahead of any token's
second choice, tokens in group order within a choice, so a choice past
its expert's C rows is dropped (contributes nothing) by that priority.

The reference expresses dispatch and combine as one-hot einsums.  Here
the same function runs as index work with fixed shapes: an integer
scatter builds each group's (E, C) slot -> token table (a slot has at
most one writer), the slots' rows are gathered, each projection is one
``bmm`` over the experts, and each token gathers its K expert outputs
back and sums them, weighted by its combine weights in bf16, in f32.
No step reads a value on the host, sizes a tensor by data, or adds
floats with atomics, so the decode and prefill chunks that run it can be
captured as CUDA graphs and replay bitwise as their eager twins.

The serve paths' decode and verify steps (``live`` / ``slab``) compute
the router logits and the shared experts at the step's padded rows,
slab by slab, as every other row op of the step, and run each routing
group's experts in a launch of its own: the card's GEMMs change bits
with M, so logits computed at the live row count could round a near-tie
one way in a decode step (B rows) and the other in a verify step
(B*(spec_k + 1) rows).  A token's expert output then depends only on its
expert and its place in that expert's queue, never on the row count;
which place it gets, and whether it is dropped, still depends on the
other tokens routed in its group, as in the reference.

Top-k takes a stable descending sort: ties (the zero pad rows' uniform
probabilities) go to the lower expert index, as ``jax.lax.top_k``'s do.

The load-balance aux loss is ``aux_loss``; ``moe_ffn`` returns it
beside its output when the training forward asks (``with_aux``), the
serve paths never pay for it.  Its gradient reaches the router through
the mean probabilities alone (the one-hot token fractions are constant),
as in the reference; the router's other gradient comes through the
combine weights, and a dropped (token, choice) pair, weighted 0, adds
nothing forward or backward.  ``probe`` (models/routing.py) sees every
call's routing under its layer and may replace it; it is None outside
oracles and tests.

On sharded (DTensor) activations the routing groups are each rank's
own (``_moe_ffn_sharded``): x is split over the rules' ``moe_groups``
axes along its batch dim (the paged paths' rows over the ``batch``
axes) where every shard then holds whole groups (else it is
replicated), the weights are gathered (FSDP), and the function above
runs on each rank's rows as ``moe_rank``, one rank's body of
models/ranks.py; the aux loss comes back as the mean of the shards'
means (weights' gradients summed over the ranks that split the rows).

Expert parallelism (the rules' ``experts`` axes, the reference's
``train_rules(expert_parallel=True)``, where ``moe_groups`` leaves them
out): expert leaves placed with their expert dim over those axes stay
split there, gathered over the other axes alone.  Every rank of an
expert group routes its groups in full (the router replicated), builds
the dispatch of its own E / n experts and runs them; the experts'
outputs are gathered over the expert axes into the whole (G, E, C, d)
(an all-gather: every rank of an expert group holds the same groups, so
no all-to-all is needed), and the combine runs as above, the same bits
as the gathered form's.  In the backward each rank's expert
gradients come from its slice of the gathered outputs' gradient and
stay on its shard; the dispatched rows' gradient, each rank's experts'
share, is summed over the expert axes (an all-reduce in the backward).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly
from repro_torch.models.ranks import Collective, mesh_collect, run, solo
from repro_torch.models.sharding import (axes_size, current_rules,
                                         entry_axes, from_local, gathered,
                                         is_dtensor, local_sum_mean,
                                         norm_spec, placements, to_local)

# called as probe(layer, positions, routing, cfg) -> routing; see the
# module docstring
probe: Optional[Callable] = None


def init_moe(cfg: ModelConfig, normal: Callable[..., torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """One layer's MoE parameters at the reference's scales: the router
    f32 (d, E), the experts' GLU weights bf16 (E, d, f) / (E, f, d) and,
    with shared experts, their GLU weights (d, n f) / (n f, d).
    ``normal(shape, std, dtype)`` draws the scaled normals."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_d_ff, m.num_experts
    sd, sf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal((d, E), sd, torch.float32),
         "we_gate": normal((E, d, f), sd),
         "we_up": normal((E, d, f), sd),
         "we_down": normal((E, f, d), sf)}
    if m.num_shared_experts:
        fs = m.num_shared_experts * f
        p.update(ws_gate=normal((d, fs), sd), ws_up=normal((d, fs), sd),
                 ws_down=normal((fs, d), sf))
    return p


def capacity(cfg: ModelConfig) -> int:
    """Rows per expert and group: ceil(group_size K / E x capacity_factor)
    rounded up to a multiple of 4, at least 4."""
    m = cfg.moe
    c = int(math.ceil(m.group_size * m.top_k / m.num_experts
                      * m.capacity_factor))
    return max(4, ((c + 3) // 4) * 4)


def queue(topi: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Places of the choices topi (G, g, K) in their experts' k-major
    queues: (pos (G, g, K) int64, keep (G, g, K) bool: pos < C)."""
    G, g, K = topi.shape
    E = cfg.moe.num_experts
    # (G, K, g, E) one-hot of each choice, k-major: a running count over
    # the K*g choices gives each choice its place in its expert
    kmaj = topi.transpose(1, 2)
    onehot = (kmaj[..., None] == torch.arange(E, device=topi.device)).to(
        torch.int32)
    count = torch.cumsum(onehot.reshape(G, K * g, E), dim=1)
    pos = torch.gather(count.reshape(G, K, g, E), 3, kmaj[..., None])[
        ..., 0].transpose(1, 2) - 1
    return pos, pos < capacity(cfg)


def route(logits: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, ...]:
    """Routing of grouped tokens from their f32 router logits (G, g, E),
    x @ router.  Returns (probs (G, g, E) f32, topw (G, g, K) f32
    renormalized to sum to 1, topi (G, g, K) int64, pos, keep:
    ``queue(topi)``)."""
    K = cfg.moe.top_k
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = srt.values[..., :K], srt.indices[..., :K]
    return (probs, topw / topw.sum(dim=-1, keepdim=True), topi,
            *queue(topi, cfg))


def aux_loss(probs: torch.Tensor, topi: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """The load-balance aux loss (Switch) of one call's routing, probs
    (G, g, E) and topi (G, g, K) from ``route``: router_aux_weight * E *
    sum_e f_e * P_e, meaned over the groups, f32 scalar."""
    m = cfg.moe
    E = m.num_experts
    chosen = topi[..., None] == torch.arange(E, device=topi.device)
    f_e = chosen.sum(dim=2).float().mean(dim=1)               # (G, E)
    p_e = probs.mean(dim=1)
    return m.router_aux_weight * E * (f_e * p_e).sum(dim=-1).mean()


def _experts(p: Dict[str, torch.Tensor], ein: torch.Tensor,
             act: str) -> torch.Tensor:
    """The experts' GLU of their rows ein (E, n, d): one ``bmm`` over the
    experts per projection -> (E, n, d)."""
    h = ly._act(act, torch.bmm(ein, p["we_gate"])) * torch.bmm(
        ein, p["we_up"])
    return torch.bmm(h, p["we_down"])


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            layer: int = 0, positions: Optional[torch.Tensor] = None,
            with_aux: bool = False, live: Optional[Tuple[int, int]] = None,
            slab: Optional[int] = None):
    """x: (B, S, d) bf16 -> out (B, S, d), or with ``with_aux`` (out, the
    call's aux loss ``aux_loss`` of the routing it ran, f32 scalar).
    With ``live`` = (B, S), x is (rows, d) instead, the B*S rows of
    (B, S) first and zero padding after (the paged paths' layout), and
    so is the output, its padding rows zero; routing, capacity, dispatch
    and combine take the B*S live rows alone, as the reference's.
    ``slab`` (with ``live``: the decode and verify steps' step rows):
    the router logits and the shared experts' GLU run over x's rows in
    slabs of that many rows and each group's experts in a launch of
    their own, so each launch has the decode step's shape
    (models/layers.py, row padding), and a live row's router logits,
    shared-expert output and, on the same expert and queue place, expert
    output are the same bits in a decode and in a verify step.
    ``layer`` and ``positions`` ((B, S) absolute positions of x's rows,
    or None) only reach ``probe``."""
    if is_dtensor(x):
        return _moe_ffn_sharded(p, x, cfg, layer, with_aux, live, slab)
    return solo(moe_rank(p, x, cfg, layer, positions, with_aux, live, slab))


def moe_rank(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
             layer: int = 0, positions: Optional[torch.Tensor] = None,
             with_aux: bool = False, live: Optional[Tuple[int, int]] = None,
             slab: Optional[int] = None, expert0: int = 0):
    """``moe_ffn`` as one rank's body (models/ranks.py): p's expert
    leaves hold experts [expert0, expert0 + El) of the E.  The rank
    routes every row of x, runs its experts on their rows and, when El <
    E, gathers the experts' outputs (El, G*C, d) over the ranks that
    split the experts (a "gather" along the experts) before the combine,
    the rows it dispatches marked a "fan_out" (each rank's experts'
    share of their gradient summed over the ranks); with all E experts
    it asks for nothing."""
    m = cfg.moe
    if live is None:
        B, S, d = x.shape
        xs = x.reshape(B * S, d)
    else:
        (B, S), d = live, x.shape[-1]
        xs = x
    E, K = m.num_experts, m.top_k
    T = B * S
    g = min(m.group_size, T)
    G = -(-T // g)
    C = capacity(cfg)
    dev = x.device
    xg = ly.pad_rows(xs[:T], G * g).view(G, g, d)
    if slab is None:
        logits = xg.float() @ p["router"]
    else:
        # padding rows are zero, so their logits are the zero rows' that
        # the group padding gets
        logits = ly.pad_rows(ly.by_slabs(
            lambda t: t.float() @ p["router"], xs, slab)[:T],
            G * g).view(G, g, E)
    routing = route(logits, cfg)
    if probe is not None:
        routing = probe(layer, positions, routing, cfg)
    probs, topw, topi, pos, keep = routing

    # slot -> token table of each group; slot E*C takes the dropped
    # choices and is cut off, and token index g is a zero row
    slot = torch.where(keep, topi * C + pos, E * C).reshape(G, g * K)
    tok = torch.arange(g, device=dev).repeat_interleave(K).expand(G, g * K)
    table = torch.full((G, E * C + 1), g, dtype=torch.int64, device=dev)
    table.scatter_(1, slot, tok)
    grp = torch.arange(G, device=dev)[:, None]
    xz = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)
    El = p["we_gate"].shape[0]                     # this rank's experts
    if El != E:     # each rank dispatches rows to its own experts alone
        xz = yield Collective("fan_out", xz)
    ein = xz[grp, table[:, expert0 * C:(expert0 + El) * C]]   # (G,El*C,d)
    ein = ein.view(G, El, C, d).transpose(0, 1).reshape(El, G * C, d)
    if slab is None or G == 1:
        eout = _experts(p, ein, cfg.act)                     # (El, G*C, d)
    else:
        eout = torch.cat([_experts(p, e.contiguous(), cfg.act)
                          for e in ein.split(C, dim=1)], dim=1)
    if El != E:
        eout = yield Collective("gather", eout, dim=0)
    eout = eout.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each token's K outputs, weighted in bf16, summed in f32
    w = torch.where(keep, topw.to(ly.PDTYPE), 0).float()      # (G, g, K)
    rows = eout[grp, torch.where(keep.reshape(G, g * K), slot, 0)]
    y = (rows.view(G, g, K, d).float() * w[..., None]).sum(dim=2)
    y = y.to(x.dtype)
    if m.num_shared_experts:
        shared = lambda t: ly.glu_ffn(
            {"w_gate": p["ws_gate"], "w_up": p["ws_up"],
             "w_down": p["ws_down"]}, t, cfg.act)
        if slab is None:
            y = y + shared(xg)
        else:
            y = y + ly.pad_rows(ly.by_slabs(shared, xs, slab)[:T],
                                G * g).view(G, g, d)

    y = y.reshape(G * g, d)[:T]
    y = y.view(B, S, d) if live is None else ly.pad_rows(y, xs.shape[0])
    return (y, aux_loss(probs, topi, cfg)) if with_aux else y


EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def _expert_shard(w: torch.Tensor, rows, ep_dims: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, int]:
    """An expert leaf w (E, ., .) whose expert dim is split over the mesh
    dims ``ep_dims``, gathered over the other mesh dims alone, as this
    rank's local (El, ., .) tensor, and the index of its first expert.
    Its gradient comes back split as the leaf's experts, summed
    (``Partial``) over the mesh dims that split the rows ``rows``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    keep = tuple(Shard(0) if i in ep_dims else Replicate()
                 for i in range(mesh.ndim))
    grad = tuple(Shard(0) if i in ep_dims else
                 Partial() if isinstance(r, Shard) else Replicate()
                 for i, r in enumerate(rows))
    w = w.redistribute(mesh, keep)
    return w.to_local(grad_placements=grad), ly._local_range(w, 0)[0]


def _expert_dims(p: Dict[str, torch.Tensor], rules: dict, mesh
                 ) -> Tuple[int, ...]:
    """The mesh dims of the rules' ``experts`` axes that split every
    expert leaf's expert dim (none: the leaves are gathered whole)."""
    names = list(mesh.mesh_dim_names)
    dims = tuple(names.index(a) for a in entry_axes(rules.get("experts"))
                 if a in names and mesh.shape[names.index(a)] > 1)
    from torch.distributed.tensor import Shard
    for k in EXPERT_LEAVES:
        w = p.get(k)
        if not dims or not is_dtensor(w) or any(
                w.placements[i] != Shard(0) for i in dims):
            return ()
    return dims


def _moe_ffn_sharded(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, layer: int, with_aux: bool,
                     live: Optional[Tuple[int, int]], slab: Optional[int]):
    """``moe_ffn`` of a DTensor x (module docstring): group-local on every
    rank, expert-parallel where the rules and the expert leaves'
    placements say so.  ``probe`` sees no positions here."""
    mesh = x.device_mesh
    rules = current_rules() or {}
    if live is None:
        (B, S), gax = x.shape[:2], rules.get("moe_groups")
    else:               # the paged paths' rows, split over the batch axes
        (B, S), gax = live, rules.get("batch")
        if x.shape[0] != B * S:                 # padded decode rows
            gax = None
    n = axes_size(gax, dict(zip(mesh.mesh_dim_names, mesh.shape)))
    g = min(cfg.moe.group_size, B * S)
    if B % n or (B // n) * S % g:
        gax, n = None, 1
    spec = norm_spec((gax,) + (None,) * (x.ndim - 1))
    rows = placements(spec, mesh)
    ep = _expert_dims(p, rules, mesh)
    lp = {k: gathered(v, rows) for k, v in p.items()
          if not (ep and k in EXPERT_LEAVES)}
    e0 = 0
    for k in EXPERT_LEAVES if ep else ():
        lp[k], e0 = _expert_shard(p[k], rows, ep)
    xl = to_local(x, spec)
    names = mesh.mesh_dim_names
    out = run(moe_rank(lp, xl, cfg, layer, None, with_aux,
                       None if live is None else (B // n, S), slab, e0),
              mesh_collect(mesh, [names[i] for i in ep]))
    if not with_aux:
        return from_local(out, mesh, spec)
    y, aux = out
    # aux is the mean over this rank's groups, all ranks' alike in size
    n = x.shape[0] // xl.shape[0]
    return (from_local(y, mesh, spec),
            local_sum_mean(aux, n, mesh, rows))
