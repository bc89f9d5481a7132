"""The one generator of every traffic mix (``traffic/<mix>.json``).

A mix is data: its ``kind`` names the loop that drives it
(``drivers/<kind>.py``) and the rest are parameters.  Work is made from
``--seed`` alone and knows nothing of the program.

Training mixes (``kind: train``): ``batch`` sequences of ``seq`` tokens a
step, uniform over the vocabulary, every step's rows new
(``train_tokens``).

Serving mixes (``kind: serve``): a list of ``requests`` requests
(``serve_requests``), which the clients take in order and cycle.  Each
size is drawn at evenly spaced quantiles of its distribution, so the set
of sizes is the distribution itself, and the mix's own ``sizes_seed``
orders the sets (prompts, outputs, which requests sample) and pairs
them; every run seed serves the same work, with its own token ids and
samplers' seeds.  ``prompt_tokens`` is a prompt's whole length; its
first ``shared_prefix.tokens`` tokens are one of ``shared_prefix.count``
prompts that all requests share (a system prompt), the rest fresh.  A
length's ``dist`` is ``lognormal`` (``median``, ``sigma``), ``uniform``
or ``loguniform``, each clipped to ``min`` and ``max``.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from perfbench.common import sub_seed


def train_tokens(mix: Dict[str, Any], vocab: int, seed: int, step: int,
                 device):
    """(batch, seq + 1) int64 token ids of a step: inputs are [:, :-1],
    labels [:, 1:]."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "train", step))
    return torch.randint(0, vocab, (mix["batch"], mix["seq"] + 1),
                         generator=g, device=device, dtype=torch.int64)


@dataclass
class ServeRequest:
    prompt: np.ndarray          # (S,) int32
    max_new: int
    temperature: float         # 0: greedy
    top_k: int
    sample_seed: int
    shared_len: int             # tokens of a shared prompt it starts with


def _quantile(spec: Dict[str, Any], u: float) -> float:
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(u)
        return spec["median"] * math.exp(spec["sigma"] * z)
    if spec["dist"] == "loguniform":
        return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    if spec["dist"] == "uniform":
        return lo + u * (hi - lo)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def quantile_lengths(spec: Dict[str, Any], n: int) -> List[int]:
    """``n`` lengths at the quantiles (i + 1/2) / n, clipped."""
    return [int(min(max(round(_quantile(spec, (i + 0.5) / n)), spec["min"]),
                    spec["max"])) for i in range(n)]


def serve_sizes(mix: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The mix's fixed set of request sizes, in the sizes seed's order."""
    rng = np.random.RandomState(mix["sizes_seed"])
    n = mix["requests"]
    prompts = np.array(quantile_lengths(mix["prompt_tokens"], n))
    news = np.array(quantile_lengths(mix["max_new"], n))
    n_sampled = int(round(mix.get("sampled_share", 0.0) * n))
    sampled = np.zeros(n, bool)
    sampled[:n_sampled] = True
    prompts, news, sampled = (a[rng.permutation(n)]
                              for a in (prompts, news, sampled))
    pre = mix.get("shared_prefix", {"count": 0, "tokens": 0})
    out = []
    for i in range(n):
        shared = int(rng.randint(pre["count"])) if pre["count"] else None
        out.append({"prompt": int(prompts[i]), "shared": shared,
                    "shared_tokens": pre["tokens"] if pre["count"] else 0,
                    "max_new": int(news[i]), "sampled": bool(sampled[i])})
    return out


def serve_requests(mix: Dict[str, Any], vocab: int, seed: int
                   ) -> List[ServeRequest]:
    """Every request a run may send, in the order its clients take them."""
    sizes = serve_sizes(mix)
    rng = np.random.RandomState(sub_seed(seed, "serve") % (1 << 32))
    pre = mix.get("shared_prefix", {"count": 0, "tokens": 0})
    shared_prompts = [rng.randint(0, vocab, pre["tokens"]).astype(np.int32)
                      for _ in range(pre["count"])]
    out = []
    for s in sizes:
        head = (shared_prompts[s["shared"]] if s["shared"] is not None
                else np.zeros(0, np.int32))
        tail = rng.randint(0, vocab, s["prompt"] - len(head)).astype(np.int32)
        out.append(ServeRequest(
            prompt=np.concatenate([head, tail]), max_new=s["max_new"],
            temperature=mix["temperature"] if s["sampled"] else 0.0,
            top_k=mix["top_k"] if s["sampled"] else 0,
            sample_seed=int(rng.randint(0, 2 ** 31 - 1)),
            shared_len=len(head)))
    return out
