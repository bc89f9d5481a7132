"""Serving subsystem of the port: continuous batching over a paged KV pool.

  prefix_cache.py — count-min gated prefix admission over refcounted
                    pool block ids
  scheduler.py    — slot scheduler, BlockAllocator and the decode chunk
  frontend.py     — AsyncServeEngine: the always-on asyncio pump
  engine.py       — ServeEngine facade (batched generate)
"""
