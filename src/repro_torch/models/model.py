"""Public model API of the port (``repro/models/model.py``): the step
functions a trainer, a server and the dry run drive, and the dry run's
input specs.

``param_specs``, ``cache_specs`` and ``input_specs`` build their trees
on the ``meta`` device: shapes and dtypes, no storage (the counterpart
of ``jax.eval_shape``).  Token ids and labels are int64 (the reference's
are int32; PyTorch indexes with int64).

The attention families keep their KV in the paged pool only (there is
no dense per-slot cache, and ``transformer.init_cache`` / ``prefill``
are the recurrent families').  So for them a decode cache is a pool of
``batch x max_seq`` rows with its block tables, ``{"kv": {"k", "v"},
"tables": (batch, nb)}``; the serve step is ``decode_step`` on it and
the prefill step writes the whole prompt as one ``prefill_chunk`` of
every slot at offset 0.  The decode ``index`` is per slot, (B,) int32.

``split`` = (n_b, n_kv) lays the blocks out for a pool whose block axis
is split n_b x n_kv ways, slot groups major (launch/shardings.py:
``cache_pspecs``): slot group g (batch / n_b consecutive slots) owns the
g-th n_kv shards, and block j of a slot lies in the group's shard
j % n_kv, so each shard holds nb / n_kv blocks of each of the group's
slots (split-KV).  The pool is padded so that each shard has the same
number of blocks and the write sink stays last and unreferenced.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import is_dtensor, replicate
from repro_torch.models.transformer import Params


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree on the meta device (no allocation)."""
    return tf.init_params(cfg, device="meta")


def init_slot_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device: DeviceLike = None,
                    split: Tuple[int, int] = (1, 1),
                    tail: Optional[Tuple[int, int]] = None) -> dict:
    """A decode cache of ``batch`` slots of ``max_seq`` rows: a recurrent
    family's ``init_cache``, or an attention family's paged pool with
    its tables, laid out for a ``split`` = (n_b, n_kv) block axis
    (module docstring).  ``tail`` = (rows, cols) adds a sketched engine's
    zeroed FCS tail tables (serve/kv_sketch.py) as ``cache["tail"]``."""
    dev = resolve_device(device)
    if cfg.family in tf.RECURRENT_FAMILIES:
        return tf.init_cache(cfg, batch, max_seq, device=dev)
    from repro_torch.launch.shardings import pool_blocks
    n_b, n_kv = split
    bs = cfg.serve.kv_block_size
    nb = -(-max_seq // bs)
    if batch % n_b or nb % n_kv:
        raise ValueError(f"{batch} slots of {nb} blocks do not split "
                         f"{n_b} x {n_kv} ways")
    NB = pool_blocks(batch * nb, n_b * n_kv)
    per = (NB + 1) // (n_b * n_kv)          # blocks a shard holds
    cache = tf.init_paged_cache(cfg, NB, bs, device=dev,
                                tail=None if tail is None else (batch,
                                                                *tail))
    grp = batch // n_b
    b = torch.arange(batch, device=dev)[:, None]
    j = torch.arange(nb, device=dev)[None, :]
    phys = (((b // grp) * n_kv + j % n_kv) * per + (j // n_kv) * grp
            + b % grp)
    cache["tables"] = phys.to(torch.int32)
    return cache


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                split: Tuple[int, int] = (1, 1)) -> dict:
    """``init_slot_cache`` on the meta device."""
    return init_slot_cache(cfg, batch, max_seq, "meta", split)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                split: Tuple[int, int] = (1, 1)) -> Dict[str, Any]:
    """Meta inputs of the step ``shape.kind`` selects:

    train   -> {"batch": {tokens | embeds, labels}}
    prefill -> {"batch": {tokens | embeds}} (+ "cache", attention families)
    decode  -> {"cache": <tree>, "tokens": (B, 1), "index": (B,)}
    """
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    stub = cfg.frontend != "none"
    if shape.kind in ("train", "prefill"):
        if stub:
            batch = {"embeds": meta((B, S, cfg.d_model), ly.PDTYPE)}
        else:
            batch = {"tokens": meta((B, S), torch.int64)}
        if shape.kind == "train":
            batch["labels"] = meta((B, S), torch.int64)
            return {"batch": batch}
        out = {"batch": batch}
        if cfg.family not in tf.RECURRENT_FAMILIES:
            out["cache"] = cache_specs(cfg, B, S, split)
        return out
    if shape.kind == "decode":
        return {"cache": cache_specs(cfg, B, S, split),
                "tokens": meta((B, 1), torch.int64),
                "index": meta((B,), torch.int32)}
    raise ValueError(shape.kind)


def make_train_step(cfg: ModelConfig
                    ) -> Callable[[Params, Dict[str, torch.Tensor]],
                                  Tuple[torch.Tensor, Params]]:
    """Gradient-only step (the optimizer is repro_torch.train's):
    ``train_step(params, batch) -> (loss, grads)``, functional like the
    reference's ``jax.value_and_grad``.  The params are marked as
    requiring grad only for the duration of the call, so the optimizer
    can update them in place afterwards; ``grads`` has the params' layout
    and dtypes; ``loss`` is a detached f32 scalar on the params' device.
    Sharded (DTensor) params give gradients on the params' placements and
    a replicated loss, as the reference's ``out_shardings``."""
    def train_step(params: Params, batch: Dict[str, torch.Tensor]):
        leaves = [t for _, pieces in tf.param_leaves(params) for t in pieces]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = tf.loss_fn(params, batch, cfg)
            # a leaf the loss does not read (the embedding table under a
            # frontend stub's embeds) gets zeros, as from jax.grad
            flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        by_id = {}
        for t in leaves:
            g = next(flat)
            g = torch.zeros_like(t) if g is None else g
            if is_dtensor(g) and g.placements != t.placements:
                # sharded params (FSDP, TP): each gradient reduced onto
                # its parameter's placement (a reduce-scatter)
                g = g.redistribute(t.device_mesh, t.placements)
            by_id[id(t)] = g
        grads = tf.tree_map(lambda t: by_id[id(t)], params)
        return replicate(loss.detach()), grads
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch, cache=None) -> (last-token logits
    (B, Vp) f32, cache)``: a recurrent family's ``prefill`` (a new
    cache), or, for an attention family, the whole (B, S) prompt written
    into ``cache`` (``init_slot_cache``) as one chunk at offset 0."""
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor],
                     cache: Optional[dict] = None):
        if cfg.family in tf.RECURRENT_FAMILIES:
            return tf.prefill(params, batch, cfg)
        x = tf.embed_inputs(params, batch)
        B = x.shape[0]
        start = torch.zeros((B,), dtype=torch.int32, device=x.device)
        y, _ = tf.forward(params, x, cfg, mode="chunk",
                          cache={"kv": cache["kv"]}, index=start,
                          tables=cache["tables"])
        return ly.logits_fn(params, y[:, -1:], cfg)[:, 0], cache
    return prefill_step


def tail_sketch(cfg: ModelConfig, cache: dict,
                fold_base: Optional[torch.Tensor] = None) -> Optional[dict]:
    """The two-span state (``transformer.forward``'s ``sketch``) of a
    paged cache with FCS tail tables, None without them: its tails, the
    (B,) ``fold_base`` (zeros: nothing folded) and the tables' hashes,
    the serve config's (``kv_sketch.tail_coeffs``) over the position
    domain of the cache's block tables.  The tails and the pool may be
    DTensors (the sharded serve path); the hashes are plain tensors on
    their device."""
    if "tail" not in cache:
        return None
    from repro_torch.serve import kv_sketch as kvs
    tail = cache["tail"]
    dev = (tail.to_local() if is_dtensor(tail) else tail).device
    B, C = tail.shape[2], tail.shape[4]
    T = cache["tables"].shape[1] * cache["kv"]["k"].shape[2]
    coeffs = kvs.tail_coeffs(cfg.serve, device=dev)
    if fold_base is None:
        fold_base = torch.zeros((B,), dtype=torch.int32, device=dev)
    return {"tail": tail, "fold_base": fold_base, "coeffs": coeffs,
            "pos_hash": kvs.pos_buckets_signs(coeffs, T, C)}


def make_serve_step(cfg: ModelConfig, kernels: Optional[bool] = None):
    """``serve_step(params, cache, tokens, index, fold_base=None) ->
    (logits (B, Vp) f32, cache)``: one decode step of every slot, the
    cache updated in place (``decode_step``; an attention family's
    through the cache's tables, ``kernels`` choosing the paged attention
    as in ``forward``).  A cache with FCS tail tables decodes two-span
    (``tail_sketch``), ``fold_base`` (B,) int32 the first position of
    each slot's exact span; its folds are ``kv_sketch.fold_pool``'s."""
    def serve_step(params: Params, cache: dict, tokens: torch.Tensor,
                   index: torch.Tensor,
                   fold_base: Optional[torch.Tensor] = None):
        if cfg.family in tf.RECURRENT_FAMILIES:
            return tf.decode_step(params, cache, tokens, index, cfg)
        logits, _ = tf.decode_step(params, {"kv": cache["kv"]}, tokens,
                                   index, cfg, tables=cache["tables"],
                                   kernels=kernels,
                                   sketch=tail_sketch(cfg, cache, fold_base))
        return logits, cache
    return serve_step
