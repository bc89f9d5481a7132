"""Recording and forcing the routing of a moe model (models/moe.py).

Routing is discontinuous: two computations of one model whose rounding
differs (the paged kernels and the plain path; a served engine and a
full-sequence recompute) route a near-tie apart, and a row routed apart
moves the rest of its sequence past any logit tolerance.  So an oracle
compares two paths as functions of the same routing: one path's routing
is recorded, the other path is forced onto it, and how far from a tie
each forced decision was is measured.

``RoutingProbe`` records or forces every ``moe_ffn`` call while it is
active, keyed by the call's layer.  ``ServedRouting`` is a probe and a
serve observer at once: attached to an engine (``obs=``) it files each
recorded call's rows under the request and position they served, and
gives a request's routing as the forcing of a full-sequence recompute.

One measure of nearness to a tie, in router logits (the log of a ratio
of router probabilities): a recorded row's ``margin`` is the smallest
gap between adjacent probabilities among its top K + 1; a forced row's
gap is how far the weakest forced expert trails the best expert it
leaves out (0 when the forcing is the row's own choice).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import moe
from repro_torch.obs import ServeObserver

Forcing = Dict[int, List[torch.Tensor]]


def _log(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p.clamp_min(1e-30))


class Call(NamedTuple):
    """One recorded ``moe_ffn`` call: its layer, the (B, S) positions of
    its rows (None in the training path), and its routing as ``moe.route``
    gives it (probs (G, g, E), topi (G, g, K), keep (G, g, K))."""
    layer: int
    positions: Optional[torch.Tensor]
    probs: torch.Tensor
    topi: torch.Tensor
    keep: torch.Tensor

    def margin(self, K: int) -> torch.Tensor:
        """(G, g) router-logit margin of each row's own choice."""
        top = torch.sort(self.probs, dim=-1, descending=True).values
        lg = _log(top[..., :K + 1])
        return (lg[..., :-1] - lg[..., 1:]).min(dim=-1).values


class RoutingProbe:
    """While active (``with``), sees every ``moe_ffn`` call.  Without
    ``forced`` it records each call (``log``, in call order).  With
    ``forced`` {layer: [topi (G, g, K), ...]} the n-th call at a layer
    takes the n-th entry's experts, queued as ``route`` queues them and
    weighted by the call's own probabilities renormalized over them; the
    forced calls are recorded too, and ``worst`` / ``differ`` / ``rows``
    say how far the forcing was from each row's own choice."""

    def __init__(self, forced: Optional[Forcing] = None):
        self.forced = forced
        self.log: list = []
        self._seen: Dict[int, int] = {}
        self._gaps: List[Tuple[torch.Tensor, torch.Tensor, int]] = []
        self._prev = None

    def __enter__(self) -> "RoutingProbe":
        self._prev, moe.probe = moe.probe, self
        return self

    def __exit__(self, *exc) -> None:
        moe.probe = self._prev

    def __call__(self, layer, positions, routing, cfg):
        probs, _, topi, pos, keep = routing
        if self.forced is not None:
            n = self._seen.get(layer, 0)
            self._seen[layer] = n + 1
            f = self.forced[layer][n].to(topi.device)
            E = cfg.moe.num_experts
            w = probs.gather(-1, f)
            chosen = (f[..., None] == torch.arange(E, device=f.device)
                      ).any(-2)
            out = probs.masked_fill(chosen, -1.0).max(-1).values
            gap = (_log(out) - _log(w.min(-1).values)).clamp(min=0)
            differ = (f.sort(-1).values != topi.sort(-1).values).any(-1)
            self._gaps.append((gap.max(), differ.sum(), differ.numel()))
            topi = f
            pos, keep = moe.queue(f, cfg)
            routing = (probs, w / w.sum(-1, keepdim=True), topi, pos, keep)
        self.log.append(Call(layer, positions, probs, topi, keep))
        return routing

    @property
    def calls(self) -> List[Call]:
        return [c for c in self.log if isinstance(c, Call)]

    def forcing(self) -> Forcing:
        """The recorded calls' experts as ``forced`` for another probe."""
        out: Forcing = {}
        for c in self.calls:
            out.setdefault(c.layer, []).append(c.topi)
        return out

    @property
    def worst(self) -> float:
        return max((float(g) for g, _, _ in self._gaps), default=0.0)

    @property
    def differ(self) -> int:
        return sum(int(d) for _, d, _ in self._gaps)

    @property
    def rows(self) -> int:
        return sum(n for _, _, n in self._gaps)


class ServedRouting(RoutingProbe, ServeObserver):
    """A recording probe that also observes one engine (pass it as the
    engine's ``obs=`` and activate it after the engine is built: every
    ``moe_ffn`` call while it is active must be that engine's).  It
    files each call under what it served:

      * a prefill chunk (a call of one row of positions) under the slot
        and offset of the ``prefill_span`` that follows it, and the
        request later ``request_admitted`` to that slot;
      * a decode step (a call of max_batch rows, one position each)
        under each slot's admitted request and the row's position;
      * on a speculative engine (``draft_layers``: its draft's depth,
        0 for a plain engine), a verify step (max_batch slots of spec_k
        + 1 positions each) likewise row by row, and a draft micro-step
        (max_batch rows, one position each: a call of the draft, not of
        the served model) as a draft call; a prefill chunk runs the
        target's layers, then the draft's.

    ``contexts()`` gives each call's context; ``forcing_of`` a request's
    routing for a full-sequence recompute."""

    def __init__(self, num_layers: int, max_batch: int,
                 draft_layers: int = 0):
        if max_batch < 2:
            raise ValueError("a decode step of one row looks like a "
                             "prefill chunk: max_batch must be > 1")
        RoutingProbe.__init__(self)
        ServeObserver.__init__(self)
        self.num_layers = num_layers
        self.draft_layers = draft_layers
        self.prompt_len: Dict[int, int] = {}

    def request_queued(self, rid, prompt_len, priority):
        super().request_queued(rid, prompt_len, priority)
        self.prompt_len[rid] = int(prompt_len)

    def prefill_span(self, slot, off, rows, dur_s):
        super().prefill_span(slot, off, rows, dur_s)
        self.log.append(("prefill", int(slot), int(off)))

    def request_admitted(self, rid, slot, prefix_hit):
        super().request_admitted(rid, slot, prefix_hit)
        self.log.append(("admitted", int(rid), int(slot)))

    def request_preempted(self, rid, slot, n_emitted):
        super().request_preempted(rid, slot, n_emitted)
        self.log.append(("vacated", int(slot)))

    def request_finished(self, rid, status, n_tokens):
        super().request_finished(rid, status, n_tokens)
        self.log.append(("finished", int(rid)))

    def contexts(self) -> List[Tuple[Call, Optional[tuple]]]:
        """Every recorded call in call order with its context:
        ("prefill", rid, off), or ("decode", [(rid or None, position)
        per routed row]) — a verify step's rows slot-major, then (None,
        -1) for each group-padding row — or, on a speculative engine,
        the draft's calls: ("draft", [(rid or None, position) per slot])
        and ("draft prefill", rid, off); None for a call that served no
        admitted request."""
        calls = self.calls
        index = {id(c): i for i, c in enumerate(calls)}
        ctx: List[Optional[tuple]] = [None] * len(calls)
        pending: List[Call] = []
        chunks: Dict[int, list] = {}
        slot_rid: Dict[int, int] = {}
        for e in self.log:
            if isinstance(e, Call):
                if e.positions.shape[0] == 1:
                    pending.append(e)
                    continue
                B, S = e.positions.shape
                if S > 1 and not self.draft_layers:
                    raise ValueError("a verify step on an engine not "
                                     "filed as speculative")
                rows = [(slot_rid.get(s), p) for s, ps in
                        enumerate(e.positions.tolist()) for p in ps]
                pad = e.topi.shape[0] * e.topi.shape[1] - len(rows)
                kind = "draft" if self.draft_layers and S == 1 else "decode"
                ctx[index[id(e)]] = (kind, rows + [(None, -1)] * pad)
            elif e[0] == "prefill":
                n = self.num_layers + self.draft_layers
                if len(pending) != n:
                    raise ValueError(f"{len(pending)} calls ahead of a "
                                     f"prefill chunk of {n} layers")
                chunks.setdefault(e[1], []).append((pending, e[2]))
                pending = []
            elif e[0] == "admitted":
                _, rid, slot = e
                for cs, off in chunks.pop(slot, []):
                    for i, c in enumerate(cs):
                        kind = ("prefill" if i < self.num_layers
                                else "draft prefill")
                        ctx[index[id(c)]] = (kind, rid, off)
                slot_rid[slot] = rid
            elif e[0] == "vacated":
                slot_rid.pop(e[1], None)
            else:
                slot_rid = {s: r for s, r in slot_rid.items() if r != e[1]}
        return list(zip(calls, ctx))

    def forcing_of(self, tokens: Sequence[int], rid: int,
                   served: Dict[int, Sequence[int]], cfg,
                   device) -> Forcing:
        """Forcing for a full-sequence forward of ``tokens`` (request
        ``rid``'s prompt and all but its last served token): position p
        takes the experts request ``rid``'s decode step at p chose or,
        in the prompt below its last row, those of the prefill chunk
        that computed row p of any request whose prompt agrees with
        ``tokens`` up to p (``served``: rid -> prompt tokens; a prefix
        hit reads rows another request computed; other requests' rows
        are passed over).  Pad rows of the last
        group take experts 0..K-1, as zero rows do.  A plain engine's
        calls only (``draft_layers`` 0)."""
        if self.draft_layers:
            raise ValueError("forcing_of reads a plain engine's calls")
        K = cfg.moe.top_k
        T = len(tokens)
        g = min(cfg.moe.group_size, T)
        G = -(-T // g)
        S = self.prompt_len[rid]
        decode: Dict[Tuple[int, int], np.ndarray] = {}
        prompt: Dict[Tuple[tuple, int], np.ndarray] = {}
        for c, cx in self.contexts():
            if cx is None:
                continue
            topi = c.topi.reshape(-1, K).cpu().numpy()
            if cx[0] == "decode":
                for s, (r, p) in enumerate(cx[1]):
                    if r == rid and S - 1 <= p < T:
                        decode.setdefault((p, c.layer), topi[s])
                continue
            _, r, off = cx
            if r not in served:
                continue
            toks = tuple(served[r])
            for i in range(min(len(topi), len(toks) - 1 - off)):
                prompt.setdefault((toks[:off + i + 1], c.layer),
                                  topi[i])
        out: Forcing = {}
        for layer in range(self.num_layers):
            f = np.tile(np.arange(K), (G * g, 1))
            for p in range(T):
                f[p] = (decode[(p, layer)] if p >= S - 1 else
                        prompt[(tuple(tokens[:p + 1]), layer)])
            out[layer] = [torch.as_tensor(f.reshape(G, g, K), device=device)]
        return out
