"""Training loop (port of ``repro/train/loop.py``):

  * checkpoint cadence with atomic writes and resume from LATEST (the data
    is stateless-seeded by step and the optimizer state is saved, so a
    resumed run on the CPU continues bit for bit; on the card the
    ``sketch_update`` kernel's shared-memory f32 atomics add a slab's
    entries in a varying order, so a resumed sketched run agrees within
    that rounding);
  * a straggler monitor: steps slower than ``straggler_factor`` x the
    EMA of step wall time are logged and listed;
  * a loss-spike record: steps whose loss is above ``spike_factor`` x the
    loss EMA are listed in ``TrainHistory.spikes`` and applied all the
    same (the reference records them in ``skipped`` and never skips);
  * sketched optimizer state when ``cfg.sketch.opt_state_ratio > 0``;
  * optional FCS gradient compression (``grad_compression``;
    train/grad_compress.py): every leaf of at least 64Ki elements is
    replaced by its sketch's unbiased estimate each step, before the
    optimizer and ``on_grads`` see it, with hashes drawn fresh from
    (``cfg.sketch.seed``, step, leaf); the placeholder error-feedback
    state is checkpointed beside params and optimizer state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import data as data_lib
from repro_torch.train.grad_compress import (_leaf_codecs,
                                             init_error_feedback,
                                             make_compressed_train_step)
from repro_torch.train.optimizer import make_optimizer

StepCallback = Callable[[int, tf.Params, tf.Params, Any], None]


@dataclass
class TrainHistory:
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    spikes: List[int] = field(default_factory=list)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = False, grad_compression: Optional[bool] = None,
          straggler_factor: float = 3.0, spike_factor: float = 4.0,
          log_every: int = 10, crash_at_step: Optional[int] = None,
          log_fn: Callable[[str], None] = print,
          device: DeviceLike = None,
          on_grads: Optional[StepCallback] = None) -> TrainHistory:
    """Single-process trainer on ``device`` (default the card).
    ``on_grads(step, params, grads, opt_state)``, when given, is called
    each step with the gradients the optimizer will apply (compressed,
    with ``grad_compression``), before it changes anything (an
    inspection hook: it must not mutate)."""
    compress = (cfg.sketch.grad_compression if grad_compression is None
                else grad_compression)
    dev = resolve_device(device)
    params = tf.init_params(cfg, seed=seed, device=dev)
    opt_init, opt_update = make_optimizer(cfg, lr=lr)
    opt = opt_init(params)
    if cfg.sketch.opt_state_ratio > 0:
        from repro_torch.sketch.optimizer import moment_state_bytes
        b = moment_state_bytes(opt)
        shrink = (b["sketched_dense_equiv"] / b["sketched"]
                  if b["sketched"] else 1.0)
        log_fn(f"[opt] sketched moments: {b['sketched']} B sketched "
               f"({shrink:.1f}x vs dense) + {b['dense']} B dense leaves")
    ef = None
    if compress:
        ef = init_error_feedback(params)
        codecs = [c for c in _leaf_codecs(params, cfg.sketch.grad_hash_ratio)
                  if c is not None]
        n = sum(c.I1 * c.k - c.pad for c in codecs)
        log_fn(f"[grad-compress] {len(codecs)} of {len(ef)} leaves "
               f"compressed at ratio {cfg.sketch.grad_hash_ratio}: "
               f"{sum(c.Jt for c in codecs)} sketch floats a step for "
               f"{n} gradient elements")
    start_step = 0
    state: Dict[str, Any] = {"params": params, "opt": opt, "ef": ef}
    if resume and ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
        start_step, _ = ckpt_lib.restore(ckpt_dir, state)
        params, opt, ef = state["params"], state["opt"], state["ef"]
        log_fn(f"[resume] from step {start_step}")

    if compress:
        train_step = make_compressed_train_step(cfg)
    else:
        base_step = M.make_train_step(cfg)
        train_step = lambda p, e, b, s: (*base_step(p, b), e)
    hist = TrainHistory()
    ema_time = None
    ema_loss = None
    for step in range(start_step, steps):
        if crash_at_step is not None and step == crash_at_step:
            raise RuntimeError(f"injected crash at step {step}")
        bd = data_lib.make_batch(cfg, step, batch, seq, seed, dev)
        t0 = time.time()
        loss, grads, ef = train_step(params, ef, bd, step)
        if on_grads is not None:
            on_grads(step, params, grads, opt)
        params, opt = opt_update(grads, opt, params)
        del grads     # else the next backward runs with two sets alive
        loss = float(loss)            # waits for the step's device work
        dt = time.time() - t0
        hist.losses.append(loss)
        hist.step_times.append(dt)
        if ema_time is not None and dt > straggler_factor * ema_time:
            hist.stragglers.append(step)
            log_fn(f"[straggler] step {step}: {dt:.3f}s vs EMA "
                   f"{ema_time:.3f}s")
        ema_time = dt if ema_time is None else 0.9 * ema_time + 0.1 * dt
        if ema_loss is not None and loss > spike_factor * max(ema_loss, 1e-6):
            hist.spikes.append(step)
        ema_loss = loss if ema_loss is None else 0.9 * ema_loss + 0.1 * loss
        if step % log_every == 0:
            log_fn(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1,
                          {"params": params, "opt": opt, "ef": ef},
                          extra={"cfg": cfg.name})
    return hist
