"""Serving subsystem of the port: continuous batching over a paged KV pool.

  prefix_cache.py — count-min gated prefix admission over refcounted
                    pool block ids
  scheduler.py    — slot scheduler, BlockAllocator and the decode chunk
  frontend.py     — AsyncServeEngine: the always-on asyncio pump
  engine.py       — ServeEngine facade (batched generate)

Observability: the scheduler, its prefix cache and the front end each
hold an optional ``obs`` attribute (a ``repro_torch.obs.ServeObserver``
or None) and guard each hook site with one attribute check — request
lifecycle spans, pump-phase and prefill-launch host times, fold / spec /
prefix events and the opt-in sketch-fidelity probe stream out with no
added device sync and nothing inside a captured chunk.  See
``repro_torch.obs``.
"""
