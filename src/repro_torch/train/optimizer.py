"""AdamW over the port's parameter dicts (``repro/train/optimizer.py``).

Optimizer state is f32 (m, v) shaped like the params.  The port updates
params and moments in place (the reference returned new pytrees); the
``update(grads, state, params) -> (params, state)`` protocol is kept, so
a caller may use the returned objects, which are the ones it passed.

``make_optimizer`` is the config-driven entry point: with
``cfg.sketch.opt_state_ratio > 0`` it returns the sketched AdamW of
repro_torch.sketch.optimizer (moments in count-sketch tables, through the
``sketch_update`` kernel on the card); otherwise the dense AdamW below.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import Params, tree_map


@dataclasses.dataclass
class AdamWState:
    step: int                 # steps taken
    m: Any                    # f32 tree like params
    v: Any                    # f32 tree like params


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t) in f32 arithmetic, as the reference computes
    them from its int32 step (exact as Python floats)."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** t),
            float(one - np.float32(b2) ** t))


def adamw_init(params: Params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def adamw_leaf_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, *, lr: float, b1: float, b2: float,
                      eps: float, weight_decay: float, bc1: float,
                      bc2: float) -> None:
    """One AdamW leaf, in place on p, m and v: the single copy of the
    dense moment math (the sketched optimizer's dense leaves use it)."""
    gf = g.to(torch.float32)
    m.copy_(b1 * m + (1.0 - b1) * gf)
    v.copy_(b2 * v + (1.0 - b2) * torch.square(gf))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
        + weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 ) -> Tuple[Params, AdamWState]:
    """One AdamW step, in place on params and state."""
    state.step += 1
    bc1, bc2 = bias_corrections(b1, b2, state.step)
    tree_map(lambda p, g, m, v: adamw_leaf_update(
        p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, bc1=bc1, bc2=bc2),
        params, grads, state.m, state.v)
    return params, state


def make_optimizer(cfg, lr: float = 3e-4
                   ) -> Tuple[Callable[[Params], Any],
                              Callable[[Params, Any, Params],
                                       Tuple[Params, Any]]]:
    """(init, update) for the config: sketched AdamW when
    ``cfg.sketch.opt_state_ratio > 0``, dense AdamW otherwise."""
    sk = cfg.sketch
    if sk.opt_state_ratio > 0:
        from repro_torch.sketch.optimizer import (sketched_adamw_init,
                                                  sketched_adamw_update)

        def init(params):
            return sketched_adamw_init(
                params, ratio=sk.opt_state_ratio, rows=sk.opt_state_rows,
                min_elems=sk.opt_state_min_elems, seed=sk.seed)

        def update(grads, state, params):
            return sketched_adamw_update(grads, state, params, lr=lr)

        return init, update

    def update(grads, state, params):
        return adamw_update(grads, state, params, lr=lr)

    return adamw_init, update


def sgd_update(grads: Params, params: Params, lr: float = 1e-2) -> Params:
    """Plain SGD, in place on params."""
    tree_map(lambda p, g: p.copy_((p.to(torch.float32)
                                   - lr * g.to(torch.float32)).to(p.dtype)),
             params, grads)
    return params
