"""Seeded weights, made by the benchmark and handed to both sides.

Each leaf is one call of ``torch.randn`` over its whole stacked shape
(every layer at once) on the run's device, from a generator on that
device seeded by (``--seed``, the leaf's path), times the port's init
scale.  So the program and the reference get the same numbers, and the
reference can make any leaf again after the program's state is freed.
The leaves are named by their paths in the port's parameter tree; a
stacked leaf ("blocks/...") has the layer as its first dim.  Imports
nothing of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch

from perfbench.common import sub_seed

PDTYPE = torch.bfloat16          # the dtype weights are served in


def padded_vocab(conf: Dict[str, Any]) -> int:
    """The vocabulary padded to a multiple of 256, as the port lays out
    its embedding and head."""
    return -(-conf["vocab_size"] // 256) * 256


@dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]       # per layer for a stacked leaf
    layers: int                  # 0: not stacked
    std: float                   # 0: zeros
    dtype: torch.dtype = PDTYPE

    @property
    def full_shape(self) -> Tuple[int, ...]:
        return ((self.layers,) if self.layers else ()) + self.shape

    @property
    def numel(self) -> int:
        return math.prod(self.full_shape)


def leaves(conf: Dict[str, Any]) -> List[Leaf]:
    d = conf["hidden_size"]
    H, K = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    f = conf["intermediate_size"]
    L = conf["num_hidden_layers"]
    V = padded_vocab(conf)
    sd = 1.0 / math.sqrt(d)
    out = [Leaf("embed", (V, d), 0, 0.02),
           Leaf("final_norm", (d,), 0, 0.0)]
    if not conf["tie_word_embeddings"]:
        out.append(Leaf("head", (d, V), 0, sd))
    out += [Leaf("blocks/attn/wq", (d, H * hd), L, sd),
            Leaf("blocks/attn/wk", (d, K * hd), L, sd),
            Leaf("blocks/attn/wv", (d, K * hd), L, sd),
            Leaf("blocks/attn/wo", (H * hd, d), L, 1.0 / math.sqrt(H * hd)),
            Leaf("blocks/norm1", (d,), L, 0.0),
            Leaf("blocks/norm2", (d,), L, 0.0)]
    if conf["port"]["family"] == "moe":
        E = conf["num_local_experts"]
        out += [Leaf("blocks/moe/router", (d, E), L, sd, torch.float32),
                Leaf("blocks/moe/we_gate", (E, d, f), L, sd),
                Leaf("blocks/moe/we_up", (E, d, f), L, sd),
                Leaf("blocks/moe/we_down", (E, f, d), L, 1.0 / math.sqrt(f))]
    else:
        out += [Leaf("blocks/ffn/w_gate", (d, f), L, sd),
                Leaf("blocks/ffn/w_up", (d, f), L, sd),
                Leaf("blocks/ffn/w_down", (f, d), L, 1.0 / math.sqrt(f))]
    return out


def make_leaf(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """The leaf's weights in the dtype they are served in."""
    if leaf.std == 0.0:
        return torch.zeros(leaf.full_shape, dtype=leaf.dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights", leaf.path))
    t = torch.randn(leaf.full_shape, generator=g, device=device,
                    dtype=leaf.dtype)
    return t.mul_(leaf.std)


def iter_leaves(conf: Dict[str, Any], seed: int, device
                ) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    for leaf in leaves(conf):
        yield leaf, make_leaf(leaf, seed, device)


def _put(tree: dict, path: List[str], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def port_params(conf: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights in the port's parameter tree: {"embed", "head",
    "final_norm", "blocks": [per-layer dicts]}; each layer's tensor its
    own storage (the stacked draw is split and freed leaf by leaf)."""
    L = conf["num_hidden_layers"]
    params: Dict[str, Any] = {"head": None,
                              "blocks": [{} for _ in range(L)]}
    for leaf, t in iter_leaves(conf, seed, device):
        parts = leaf.path.split("/")
        if not leaf.layers:
            params[parts[0]] = t
            continue
        for layer in range(L):
            _put(params["blocks"][layer], parts[1:], t[layer].clone())
        del t
    return params
