"""Deterministic synthetic LM batches (port of ``repro/train/data.py``).

Stateless seeding: ``make_batch`` is a function of (seed, step) and the
shape alone, so a restarted run regenerates any step's batch with no data
state in the checkpoint.  The same learnable structure as the reference:
per-row periodic motifs of 8 tokens, tiled, with 10% of positions
replaced by uniform noise tokens; labels are the next token.  The draws
come from a ``torch.Generator`` and differ from ``jax.random``'s; tests
that compare the packages feed both the same numpy batches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

PERIOD = 8
NOISE_FRAC = 0.1


def make_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
               seed: int = 0, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device``."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} batches are not ported yet; see "
            f"ROADMAP Queue 1 #12")
    dev = resolve_device(device)
    g = torch.Generator()
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    V = cfg.vocab_size
    motif = torch.randint(0, V, (batch, PERIOD), generator=g)
    reps = seq // PERIOD + 2
    stream = motif.repeat(1, reps)[:, :seq + 1]
    noise = torch.randint(0, V, stream.shape, generator=g)
    is_noise = torch.rand(stream.shape, generator=g) < NOISE_FRAC
    stream = torch.where(is_noise, noise, stream)
    return {"tokens": stream[:, :seq].contiguous().to(dev),
            "labels": stream[:, 1:seq + 1].contiguous().to(dev)}

