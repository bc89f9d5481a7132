"""The plain reference of a serving cell's greedy tokens.

For each sampled request it runs the full forward once over the prompt
and the tokens the program served (``reference/model.py``, float32) and
reads, at every served token, the gap by which that token's logit lies
below the reference's best logit there (0 where the reference would have
picked it too) and its rank, the number of tokens whose logit lies above
it.  The control reads the same gaps for the tokens that the
reference computed in float8 puts first, at the same positions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import model as rm

# tokens of the requests that go through one forward
GROUP_TOKENS = 1 << 15


def reference_params(conf: Dict[str, Any], seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    return {lf.path: t.float()
            for lf, t in weights.iter_leaves(conf, seed, device)}


def _groups(requests, budget: int):
    """Consecutive runs of requests of at most ``budget`` tokens each (a
    longer request alone)."""
    group, n = [], 0
    for i, (prompt, served) in enumerate(requests):
        size = len(prompt) + len(served)
        if group and n + size > budget:
            yield group
            group, n = [], 0
        group.append(i)
        n += size
    if group:
        yield group


def gaps(conf: Dict[str, Any], seed: int, device,
         requests: Sequence[Tuple[np.ndarray, Sequence[int]]],
         control: bool = False, budget: int = GROUP_TOKENS
         ) -> List[np.ndarray]:
    """Per request (prompt, served tokens): an (n, 2) array of, at each
    served token, the float32 reference's gap (its best logit less the
    token's) and the token's rank (the reference's logits above it), or
    (``control``) those of the token the float8 reference puts first at
    that position.  Requests go through the forward in groups of at most
    ``budget`` tokens."""
    rm.strict_f32()
    P = reference_params(conf, seed, device)
    f32, fp8 = rm.matmul_fn("f32"), rm.matmul_fn("fp8")
    out: List[np.ndarray] = [None] * len(requests)
    for group in _groups(requests, budget):
        toks, rows, picks = [], [], []
        for i in group:
            prompt, served = requests[i]
            served = [int(t) for t in served]
            seq = np.concatenate([np.asarray(prompt, np.int64),
                                  np.asarray(served[:-1], np.int64)])
            toks.append(torch.as_tensor(seq, device=device))
            rows.append(torch.arange(len(prompt) - 1, len(seq),
                                     device=device))
            picks.append(torch.as_tensor(served, device=device))
        lgs = rm.logits_many(P, toks, conf, f32, rows)
        if control:
            picks = [lg.argmax(-1) for lg in
                     rm.logits_many(P, toks, conf, fp8, rows)]
        for i, lg, pick in zip(group, lgs, picks):
            at = lg.gather(1, pick[:, None])
            gap = lg.max(-1).values - at[:, 0]
            rank = (lg > at).sum(-1).to(gap.dtype)
            out[i] = torch.stack([gap, rank], 1).cpu().numpy()
    return out
