"""Deterministic synthetic LM batches (port of ``repro/train/data.py``).

Stateless seeding: ``make_batch`` is a function of (seed, step) and the
shape alone, so a restarted run regenerates any step's batch with no data
state in the checkpoint.  The same learnable structure as the reference:
per-row periodic motifs of 8 tokens, tiled, with 10% of positions
replaced by uniform noise tokens; labels are the next token.  The draws
come from a ``torch.Generator`` and differ from ``jax.random``'s; tests
that compare the packages feed both the same numpy batches.

The audio and vlm families train behind a frontend stub: their batches
carry precomputed embeddings instead of token ids, ``table[tokens %
1024]`` of a (1024, d_model) bf16 table drawn from a generator seeded
with ``seed + 1`` (the same for every step), as the reference makes them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

PERIOD = 8
NOISE_FRAC = 0.1
STUB_ROWS = 1024          # rows of the frontend stub's embedding table


def make_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
               seed: int = 0, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device``; for a
    config with a frontend stub {"embeds": (batch, seq, d_model) bf16,
    "labels"}."""
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
    tokens = stream[:, :seq].contiguous()
    labels = stream[:, 1:seq + 1].contiguous().to(dev)
    if cfg.frontend != "none":
        return {"embeds": stub_table(cfg, seed)[tokens % STUB_ROWS].to(dev),
                "labels": labels}
    return {"tokens": tokens.to(dev), "labels": labels}


def stub_table(cfg: ModelConfig, seed: int = 0) -> torch.Tensor:
    """The frontend stub's (1024, d_model) bf16 pseudo-embeddings, on the
    CPU: unit normals from a generator seeded with ``seed + 1``."""
    g = torch.Generator()
    g.manual_seed(int(seed) + 1)
    return torch.randn((STUB_ROWS, cfg.d_model), generator=g).to(
        torch.bfloat16)

