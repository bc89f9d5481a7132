"""Per-rank bodies with their collectives passed in.

A sharded path that needs the other ranks in the middle of its work is
written as a *body*: a generator that computes on its rank's shards and,
where it needs the others, yields a ``Collective`` and is sent back the
result; its return value is the path's.  The runner decides what a
collective is:

* ``run(body, mesh_collect(mesh, axes))``: one rank of a real mesh, each
  request a DTensor collective over the mesh ``axes``;
* ``run_ranks(bodies)``: n emulated ranks in one process, advanced in
  lockstep, each request carried out over the ranks' tensors in rank
  order (a gather concatenates them, a sum adds them left to right).
  ``chip_smoke.py`` runs the sharded paths this way on one card.
"""
from __future__ import annotations

import functools
from typing import Callable, Generator, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.models.sharding import from_local, norm_spec, to_local


class Collective(NamedTuple):
    """One request of a body.  ``op``: "gather" (the ranks' tensors
    concatenated along ``dim``), "sum" or "max" (elementwise over the
    ranks), or "fan_out": a tensor every rank holds alike, of which each
    rank uses its own share (the identity forward; its gradient summed
    over the ranks)."""
    op: str
    tensor: torch.Tensor
    dim: int = 0


Body = Generator[Collective, torch.Tensor, object]


def run(body: Body, collect: Callable[[Collective], torch.Tensor]):
    """Drive one rank's ``body``, ``collect`` carrying out its requests;
    returns the body's value."""
    try:
        req = next(body)
        while True:
            req = body.send(collect(req))
    except StopIteration as stop:
        return stop.value


def solo(body: Body):
    """``body`` as the only rank: every collective returns its input."""
    return run(body, lambda c: c.tensor)


def run_ranks(bodies: Sequence[Body]) -> List[object]:
    """Drive the bodies of n emulated ranks in lockstep: each step takes
    every rank's next request (all the same op), carries it out over the
    ranks' tensors in rank order and sends each rank the result.  Returns
    the bodies' values in rank order."""
    bodies = list(bodies)
    results: List[object] = [None] * len(bodies)
    sent: List[Optional[torch.Tensor]] = [None] * len(bodies)
    live = list(range(len(bodies)))
    while live:
        reqs, done = {}, []
        for r in live:
            try:
                reqs[r] = (next(bodies[r]) if sent[r] is None
                           else bodies[r].send(sent[r]))
            except StopIteration as stop:
                results[r] = stop.value
                done.append(r)
        if done and reqs:
            raise RuntimeError(f"ranks {done} finished while ranks "
                               f"{sorted(reqs)} wait on a collective")
        if not reqs:
            break
        ops = {(c.op, c.dim) for c in reqs.values()}
        if len(ops) != 1:
            raise RuntimeError(f"the ranks asked for different collectives: "
                               f"{sorted(ops)}")
        (op, dim), = ops
        ts = [reqs[r].tensor for r in live]
        if op == "fan_out":     # each rank's own tensor: autograd sums
            for r in live:      # the ranks' gradients where they meet
                sent[r] = reqs[r].tensor
            continue
        if op == "gather":
            out = torch.cat(ts, dim=dim)
        elif op == "sum":
            out = functools.reduce(torch.add, ts)
        elif op == "max":
            out = functools.reduce(torch.maximum, ts)
        else:
            raise ValueError(op)
        for r in live:
            sent[r] = out
    return results


def mesh_collect(mesh, axes: Sequence[str]
                 ) -> Callable[[Collective], torch.Tensor]:
    """Collectives of one rank of ``mesh`` over the mesh ``axes`` (none:
    every request returns its input), run on the sub-mesh of those axes:
    the ranks that differ in another axis (another slot group, routing
    group or pod) hold other rows and take no part, and no placement
    over another axis enters the collective.  Differentiable: a gather's
    gradient is the rank's slice of the gradient of the gathered tensor,
    which every rank of the group holds alike."""
    axes = tuple(axes)
    if not axes:
        return lambda c: c.tensor
    sub = mesh[axes if len(axes) > 1 else axes[0]]

    def collect(c: Collective) -> torch.Tensor:
        whole = (None,) * c.tensor.ndim
        if c.op == "gather":
            sp = list(whole)
            sp[c.dim] = axes
            t = from_local(c.tensor, sub, norm_spec(sp))
        elif c.op in ("sum", "max"):
            t = from_local(c.tensor, sub, whole, axes, c.op)
        elif c.op == "fan_out":
            from torch.distributed.tensor import Partial
            t = from_local(c.tensor, sub, whole)
            return t.to_local(grad_placements=(Partial(),) * sub.ndim)
        else:
            raise ValueError(c.op)
        return to_local(t, whole)
    return collect
