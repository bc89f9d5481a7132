"""Async serving front-end (port of ``repro/serve/frontend.py``): an
always-on admission / prefill / decode pump over the slot scheduler's
phase API.

    engine = AsyncServeEngine(cfg, params)
    handle = await engine.submit(prompt, max_new=64, priority=1,
                                 deadline_s=2.0)
    async for tok in handle.stream():
        ...                         # tokens as each decode chunk lands
    handle.cancel()                 # mid-flight: slot + blocks free now
    completion = await handle.result()

One asyncio task (the pump) owns the scheduler.  Each iteration applies
queued cancellations and expires deadlines at the pump boundary, admits
queued requests, dispatches a decode chunk (on the card this only
enqueues it), yields so new submissions land and admits them while the
chunk runs, then collects the chunk in a worker thread — so the event
loop stays live while the host waits on the card — and fans the new
tokens out to the handles.  The pump exits when the scheduler drains and
restarts on the next submit.  ``submit`` waits (never raises) while
``cfg.serve.queue_depth`` requests are already queued.

With an observer (``obs=``, shared with the scheduler) the pump reports
its host phases as spans: ``dispatch`` (the host time of launching a
chunk; on the card a graph replay) and ``collect`` (the wait for the
chunk's tokens plus their accounting), and the front end reports token
deliveries (TTFT, inter-token gaps) and backpressure waits.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Set, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import DeviceLike
from repro_torch.models.draft import Draft
from repro_torch.serve.scheduler import (Completion, EngineStats, Request,
                                         SlotScheduler)


class StreamHandle:
    """Caller-side view of one submitted request: an async token stream,
    a result future and a cancel switch."""

    def __init__(self, engine: "AsyncServeEngine", req: Request):
        self._engine = engine
        self.rid = req.rid
        self.prompt_len = len(req.tokens)
        self.tokens: List[int] = []
        self.completion: Optional[Completion] = None
        self._delivered = 0                    # pump-side watermark
        self._queue: "asyncio.Queue[Union[int, Completion]]" = \
            asyncio.Queue()
        self._done = asyncio.Event()

    @property
    def done(self) -> bool:
        return self.completion is not None

    async def stream(self) -> AsyncIterator[int]:
        """Yield tokens as the pump commits them (one delivery per decode
        chunk); ends when the request completes, cancels or expires."""
        while True:
            item = await self._queue.get()
            if isinstance(item, Completion):
                return
            self.tokens.append(item)
            yield item

    async def result(self) -> Completion:
        """Await the request's resolution and return its Completion."""
        await self._done.wait()
        return self.completion

    def cancel(self) -> None:
        """Request cancellation at the next pump boundary; a no-op once
        done."""
        if self.completion is None:
            self._engine._cancel_rids.add(self.rid)


class AsyncServeEngine:
    """The async front door.  Owns a fresh ``SlotScheduler`` (``cfg`` +
    ``params``; ``draft`` and ``graphs`` as the scheduler takes them) or
    wraps an existing one (``scheduler=``).  ``obs``: a
    ``repro_torch.obs.ServeObserver`` for the front end and its
    scheduler.  Call it from one asyncio event loop at a time."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Any = None,
                 serve: Optional[ServeConfig] = None,
                 scheduler: Optional[SlotScheduler] = None,
                 temperature: float = 0.0, device: DeviceLike = None,
                 draft: Optional[Draft] = None,
                 graphs: Optional[bool] = None, obs: Any = None):
        if scheduler is not None:
            self._sched = scheduler
        else:
            if cfg is None or params is None:
                raise ValueError("AsyncServeEngine needs (cfg, params) or "
                                 "scheduler=")
            self._sched = SlotScheduler(cfg, params, serve=serve,
                                        temperature=temperature,
                                        device=device, draft=draft,
                                        graphs=graphs)
        # observability (repro_torch.obs.ServeObserver or None): an
        # explicit observer attaches to the scheduler too; otherwise the
        # front end takes the scheduler's, so front-end and scheduler
        # hooks always land in the same observer
        if obs is not None:
            self._sched.set_observer(obs)
        self.obs = obs if obs is not None else self._sched.obs
        sv = self._sched.serve
        self.queue_depth = max(1, int(sv.queue_depth))
        self.default_deadline_s = float(sv.default_deadline_s)
        self._handles: Dict[int, StreamHandle] = {}
        self._cancel_rids: Set[int] = set()
        self._rid = 0
        self._pump_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._space: Optional[asyncio.Event] = None

    @property
    def scheduler(self) -> SlotScheduler:
        return self._sched

    # -- submission ----------------------------------------------------

    async def submit(self, tokens, max_new: int = 32, *,
                     temperature: Optional[float] = None, top_k: int = 0,
                     seed: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     spec_k: Optional[int] = None,
                     kv_sketch: Optional[bool] = None,
                     priority: int = 0,
                     deadline_s: Optional[float] = None,
                     rid: Optional[int] = None) -> StreamHandle:
        """Submit one request; returns its StreamHandle.  Waits (never
        raises) while ``queue_depth`` requests are already queued.
        ``spec_k`` sets this request's speculative tokens per round on a
        spec engine (None: the engine's; 0: plain decode);
        ``kv_sketch=False`` keeps this request's whole context exact on a
        sketched engine; ``deadline_s`` is relative to now (None -> the
        serve config's default; 0 disables); ``rid`` overrides the
        engine's counter."""
        self._ensure_loop()
        stalled_at = None
        while self._sched.queue_len >= self.queue_depth:
            if stalled_at is None:
                stalled_at = time.perf_counter()
            self._space.clear()
            await self._space.wait()
        if stalled_at is not None and self.obs is not None:
            self.obs.backpressure_wait(time.perf_counter() - stalled_at)
        if rid is None:
            rid = self._rid
            self._rid += 1
        else:
            self._rid = max(self._rid, rid + 1)
        ds = (self.default_deadline_s if deadline_s is None
              else float(deadline_s))
        deadline = time.monotonic() + ds if ds and ds > 0 else None
        req = Request(rid=rid, tokens=np.asarray(tokens, np.int32),
                      max_new=int(max_new), temperature=temperature,
                      top_k=int(top_k), seed=seed, generator=generator,
                      spec_k=spec_k, kv_sketch=kv_sketch,
                      priority=int(priority),
                      deadline=deadline)
        self._sched.submit(req)
        handle = StreamHandle(self, req)
        self._handles[rid] = handle
        # start the pump only after the request is queued: a pump that
        # wakes to an empty scheduler exits at once
        self._ensure_pump()
        return handle

    async def drain(self) -> None:
        """Wait until every submitted request has resolved."""
        while self._pump_task is not None and not self._pump_task.done():
            await self._pump_task

    async def aclose(self) -> None:
        """Cancel everything still queued or in flight and stop."""
        for h in list(self._handles.values()):
            h.cancel()
        await self.drain()

    def stats(self) -> EngineStats:
        return self._sched.stats()

    # -- the pump ------------------------------------------------------

    def _ensure_loop(self) -> None:
        """Bind (or rebind) to the running loop: asyncio primitives don't
        survive across ``asyncio.run`` calls."""
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            self._loop = loop
            self._space = asyncio.Event()
            self._pump_task = None

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = self._loop.create_task(self._pump())

    async def _pump(self) -> None:
        sched = self._sched
        obs = self.obs
        while True:
            # pump boundary: no chunk in flight, evictions are safe
            self._apply_cancels()
            for c in sched.expire_deadlines():
                self._finish(c)
            self._notify_space()
            sched.admit_pending()
            t0 = time.perf_counter()
            if not sched.dispatch():
                if not sched.pending:
                    return              # drained; next submit restarts
                await asyncio.sleep(0)  # transient: let submitters run
                continue
            if obs is not None:
                # host time of launching the chunk (fold planning, the
                # eager folds, the replay); the device work is in flight
                obs.pump_span("dispatch", t0, time.perf_counter() - t0)
            # overlap window: the chunk is queued on the card; admit what
            # arrived meanwhile so its prefill overlaps the chunk
            await asyncio.sleep(0)
            sched.admit_pending()
            t0 = time.perf_counter()
            done = await asyncio.to_thread(sched.collect)
            if obs is not None:
                # wall time of the round's one wait on the card, plus the
                # tokens' accounting and retirement
                obs.pump_span("collect", t0, time.perf_counter() - t0)
            self._deliver_progress()
            for c in done:
                self._finish(c)
            self._notify_space()
            # let consumers react to the tokens just delivered, so a
            # cancel() they issue applies before the next dispatch
            await asyncio.sleep(0)

    def _apply_cancels(self) -> None:
        while self._cancel_rids:
            c = self._sched.cancel(self._cancel_rids.pop())
            if c is not None:
                self._finish(c)

    def _deliver_progress(self) -> None:
        """Fan freshly committed tokens out to their handles."""
        for rid, toks in self._sched.progress().items():
            h = self._handles.get(rid)
            if h is None or len(toks) <= h._delivered:
                continue
            for t in toks[h._delivered:]:
                h._queue.put_nowait(int(t))
            if self.obs is not None:
                self.obs.tokens_delivered(rid, len(toks) - h._delivered)
            h._delivered = len(toks)

    def _finish(self, c: Completion) -> None:
        h = self._handles.pop(c.rid, None)
        if h is None:
            return
        total = [int(t) for t in c.tokens]
        if self.obs is not None and len(total) > h._delivered:
            self.obs.tokens_delivered(c.rid, len(total) - h._delivered)
        for t in total[h._delivered:]:
            h._queue.put_nowait(t)
        h._delivered = len(total)
        h.completion = c
        h._queue.put_nowait(c)      # ends the stream() iterator
        h._done.set()               # resolves result() awaiters

    def _notify_space(self) -> None:
        if self._space is not None and \
                self._sched.queue_len < self.queue_depth:
            self._space.set()
