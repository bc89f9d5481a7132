"""Public model API of the port (``repro/models/model.py``): the step
functions a trainer drives."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import Params


def make_train_step(cfg: ModelConfig
                    ) -> Callable[[Params, Dict[str, torch.Tensor]],
                                  Tuple[torch.Tensor, Params]]:
    """Gradient-only step (the optimizer is repro_torch.train's):
    ``train_step(params, batch) -> (loss, grads)``, functional like the
    reference's ``jax.value_and_grad``.  The params are marked as
    requiring grad only for the duration of the call, so the optimizer
    can update them in place afterwards; ``grads`` has the params' layout
    and dtypes; ``loss`` is a detached f32 scalar on the params' device."""
    def train_step(params: Params, batch: Dict[str, torch.Tensor]):
        leaves = [t for _, pieces in tf.param_leaves(params) for t in pieces]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = tf.loss_fn(params, batch, cfg)
            flat = iter(torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        by_id = {id(t): next(flat) for t in leaves}
        grads = tf.tree_map(lambda t: by_id[id(t)], params)
        return loss.detach(), grads
    return train_step
