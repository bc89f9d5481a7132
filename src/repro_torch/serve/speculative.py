"""Speculative decoding rounds: draft-propose -> verify-all -> commit
(port of ``repro/serve/speculative.py``).

A speculative ``SlotScheduler`` runs ``spec_chunk`` instead of the plain
one-token-per-step loop.  One round, for every slot at once:

  1. the draft (``models/draft.py``: a truncated and/or
     count-sketch-compressed copy of the served weights) runs K + 1 paged
     decode micro-steps through the slot's block table against its own
     shallow pool: the first K give greedy proposals d_1..d_K, the last
     only writes the draft's KV row for d_K, so the draft pool keeps pace
     with whatever prefix commits;
  2. the target scores all K + 1 positions in one multi-query step
     (``transformer.verify_step``), whose logits at position pos + i are
     bitwise a decode step's after committing the first i + 1 tokens;
  3. the longest verified prefix commits with the target's correction /
     bonus token: n + 1 tokens, n the leading proposals equal to the
     target's greedy choice, clipped to the slot's spec_k and its
     remaining budget, and 0 for sampled slots, which draw their one
     token from their own generator.  Rejection is positional: the
     slot's position does not move past the accepted prefix, and the
     rejected rows above it are rewritten by the next round before any
     query can see them.

So greedy speculative output is token for token plain greedy output,
and slots with spec_k == 0 ride the same chunk as one-verified-token
rounds.  Like the plain chunk it is device work that never waits on the
host (every per-slot decision is device data): tokens and emit flags
stay on the device, (chunk, B, K + 1), until ``collect`` copies them
once, and on the card the scheduler captures it once per variant as a
CUDA graph and replays it (serve/graphs.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.draft import Draft


def round_accounting(spec_k: int, emitted: int):
    """Host accounting of one step-row of a speculating slot: given its
    proposal budget and the tokens it committed this round, returns
    (rounds, proposed, accepted).  A round emits the accepted proposals
    plus the target's token, so ``emitted - 1`` of ``spec_k`` proposals
    survived; a slot without proposals, or a round that emitted nothing,
    counts nothing."""
    if spec_k <= 0 or emitted <= 0:
        return 0, 0, 0
    return 1, spec_k, emitted - 1


def spec_chunk(params, draft: Draft, cfg: ModelConfig, state,
               tables: torch.Tensor, decode_chunk: int, spec_max: int,
               sample: Callable[[torch.Tensor], torch.Tensor], rows: int,
               kernels: Optional[bool] = None,
               sketch: Optional[dict] = None,
               draft_sketch: Optional[dict] = None) -> torch.Tensor:
    """Enqueue ``decode_chunk`` rounds over every slot of ``state`` (the
    scheduler's ``DecodeState``, updated in place: pools, cur, pos,
    remaining) through the block ``tables`` the model sees (B, nb).
    ``sample(logits (B, V))`` is the scheduler's per-slot
    sampler (argmax for greedy slots, every slot at once).  ``rows``: the padded row count of
    the verify step, the plain engine's decode row count
    (models/layers.py, row padding); the draft's micro-steps, whose
    proposals only decide what is verified, run unpadded.
    ``sketch`` / ``draft_sketch``:
    the two-span states of the target and the draft (their own tails,
    one fold_base), already folded at the chunk head.  Returns the
    stacked (2, chunk, B, K + 1) int64 tokens and emit flags on the
    device; a round's emitted tokens are the leading flagged entries of
    its row, in order."""
    K = spec_max
    V = cfg.vocab_size
    dev = state.pos.device
    ar = torch.arange(K + 1, device=dev)
    # proposals a slot may accept: its spec_k, greedy slots only
    eligible = ((ar[None, :K] < state.spec_k.clamp(max=K)[:, None])
                & (state.temp[:, None] == 0.0))
    target = {"kv": state.cache["kv"]}
    dcache = state.cache["draft"]
    toks, emits = [], []
    for _ in range(decode_chunk):
        tok = state.cur
        fed = [tok[:, 0]]
        for i in range(K + 1):
            lg, _ = tf.decode_step(draft.params, dcache, tok, state.pos + i,
                                   draft.cfg, tables, kernels=kernels,
                                   sketch=draft_sketch)
            if i < K:
                tok = torch.argmax(lg[:, :V], dim=-1)[:, None]
                fed.append(tok[:, 0])
        vtok = torch.stack(fed, dim=1)                       # (B, K + 1)
        logits, _ = tf.verify_step(params, target, vtok, state.pos, cfg,
                                   tables, kernels=kernels, sketch=sketch,
                                   rows=rows)
        lg = logits[..., :V]
        greedy = torch.argmax(lg, dim=-1)                    # (B, K + 1)
        match = (vtok[:, 1:] == greedy[:, :-1]) & eligible
        n = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1,
                                                          dtype=torch.int32)
        out = greedy.clone()
        out[:, 0] = sample(lg[:, 0])
        e = torch.minimum(n + 1, state.remaining)            # emitted
        last = out.gather(1, (e - 1).clamp(min=0).long()[:, None])[:, 0]
        state.cur.copy_(torch.where(e > 0, last, state.cur[:, 0])[:, None])
        state.pos.add_(e)
        state.remaining.sub_(e)
        toks.append(out)
        emits.append((ar[None, :] < e[:, None]).to(torch.int64))
    return torch.stack([torch.stack(toks), torch.stack(emits)])
