"""Serving engine facade (port of ``repro/serve/engine.py``).

``ServeEngine.generate`` keeps the batched API — a (B, S) prompt matrix
in, a (B, max_new) token matrix out — as a thin wrapper over the async
front-end: each batch row becomes one streamed submission against the
cached scheduler's pump, drained inside an ``asyncio.run``.  Greedy batch
output is the streamed output; there is one serving path.  With
``cfg.serve.spec_k > 0`` the draft is derived once per weights and
shared by every scheduler the engine builds.  ``graphs`` is passed to
each scheduler (serve/graphs.py: None captures the decode chunk as CUDA
graphs on the card; False keeps the eager chunk).  One observer
(``obs=`` / ``set_observer``, a ``repro_torch.obs.ServeObserver``) is
shared by every scheduler and front end the engine builds, so the merged
``EngineStats`` and the observer's series describe the same engine.
"""
from __future__ import annotations

import asyncio
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.draft import make_draft
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import EngineStats, SlotScheduler

Per = Union[float, int, Sequence, np.ndarray]


@dataclass
class GenerationResult:
    tokens: torch.Tensor       # (B, max_new) int32, on the host
    prompt_len: int


def _per_request(val: Per, B: int, name: str) -> np.ndarray:
    """Broadcast a scalar or validate a length-B per-request vector."""
    arr = np.asarray(val)
    if arr.ndim == 0:
        return np.full((B,), arr.item())
    if arr.shape != (B,):
        raise ValueError(f"{name} must be scalar or ({B},), got "
                         f"{arr.shape}")
    return arr


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_seq: int = 512,
                 max_batch: Optional[int] = None,
                 device: DeviceLike = None,
                 graphs: Optional[bool] = None, obs=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.graphs = graphs
        self._frontends = {}         # max_batch -> AsyncServeEngine
        self._draft = None           # derived once per weights
        self._rid = 0
        self._obs = obs

    def set_observer(self, obs) -> None:
        """Attach (or detach, with None) an observer: it applies to every
        live scheduler and front end now and to those built later."""
        self._obs = obs
        for f in self._frontends.values():
            f.scheduler.set_observer(obs)
            f.obs = obs

    def _frontend(self, batch: int) -> AsyncServeEngine:
        """One scheduler (and front-end) per slot count, reused across
        calls so the prefix cache warms up; dropped when ``self.params``
        is swapped, since its cached KV came from the old weights."""
        if self._frontends and next(iter(self._frontends.values())
                                    ).scheduler.params is not self.params:
            self._frontends.clear()
            self._draft = None       # derived from the old weights
        kb = self.max_batch or batch
        if kb not in self._frontends:
            serve = dataclasses.replace(self.cfg.serve, max_batch=kb,
                                        max_seq=self.max_seq)
            if serve.spec_k > 0 and self._draft is None:
                # the derivation is a real pass (count sketches of every
                # block matrix) and does not depend on the slot geometry
                self._draft = make_draft(self.params, self.cfg, serve)
            self._frontends[kb] = AsyncServeEngine(scheduler=SlotScheduler(
                self.cfg, self.params, serve=serve, device=self.device,
                draft=self._draft, graphs=self.graphs, obs=self._obs))
        return self._frontends[kb]

    def generate(self, tokens, max_new: int = 32, temperature: Per = 0.0,
                 top_k: Per = 0, seed: Optional[int] = None,
                 spec_k: Optional[Per] = None,
                 kv_sketch: Optional[Per] = None) -> GenerationResult:
        """tokens: (B, S) prompt ids.  ``temperature`` / ``top_k`` may be
        scalars or length-B vectors; a request is greedy when its
        temperature is 0.  ``seed`` seeds row b's sampler with seed + b,
        so two calls with one seed draw the same tokens; without it the
        generators derive from cfg.serve.seed and the request id.
        ``spec_k`` (scalar or per-request) sets speculative tokens per
        round, defaulting to ``cfg.serve.spec_k`` and clamped to it: an
        engine built with spec_k > 0 speculates, and a request may opt
        down to plain decode with 0.
        ``kv_sketch`` (scalar or per-request bools) opts requests out of
        long-context KV sketching on engines built with
        ``cfg.serve.kv_sketch_window > 0``: False keeps that request's
        whole context exact."""
        prompts = np.asarray(tokens, np.int32)
        B, S = prompts.shape
        if S + max_new > self.max_seq:
            raise ValueError(f"prompt {S} + max_new {max_new} exceeds "
                             f"max_seq {self.max_seq}")
        front = self._frontend(B)
        temps = _per_request(temperature, B, "temperature")
        ks = _per_request(top_k, B, "top_k")
        sks = (None if spec_k is None
               else _per_request(spec_k, B, "spec_k"))
        kss = (None if kv_sketch is None
               else _per_request(kv_sketch, B, "kv_sketch"))
        rids = list(range(self._rid, self._rid + B))
        self._rid += B

        async def go():
            handles = []
            for b in range(B):
                handles.append(await front.submit(
                    prompts[b], max_new=max_new,
                    temperature=float(temps[b]), top_k=int(ks[b]),
                    seed=None if seed is None else seed + b,
                    spec_k=None if sks is None else int(sks[b]),
                    kv_sketch=None if kss is None else bool(kss[b]),
                    deadline_s=0,         # batch callers never expire
                    rid=rids[b]))
            return [await h.result() for h in handles]

        done = asyncio.run(go())
        out = np.stack([c.tokens for c in done])
        return GenerationResult(tokens=torch.as_tensor(out), prompt_len=S)

    @property
    def decode_compilations(self) -> int:
        """Decode chunk captures across every live scheduler."""
        return sum(f.scheduler.decode_compilations
                   for f in self._frontends.values())

    @property
    def prefill_compilations(self) -> int:
        """Prefill chunk captures across every live scheduler."""
        return sum(f.scheduler.prefill_compilations
                   for f in self._frontends.values())

    def stats(self) -> EngineStats:
        """Snapshot merged across every live scheduler."""
        return EngineStats.merge(
            [f.scheduler.stats() for f in self._frontends.values()])
