"""The training loop of a ``kind: train`` mix.

Set-up builds one training state: the seed's weights in the port's
parameter tree, ``models/model.make_train_step(cfg)`` and the optimizer
of ``train/optimizer.make_optimizer(cfg)``, as ``train/loop.py:train``
builds them, and drives it through the mix's checked steps with the
window's own step call, each step on new rows.  The window then runs
more steps of that same state, a closed loop, until ``--seconds`` have
passed; a step is the loop's body (batch, loss and gradients, the
update, the loss read back).  ``train_tokens_per_s`` is every token of
every window step over the window's time.

After the window the state is freed and the reference follows the
checked steps from the same seed (``reference/train.py``); the program is
judged by each step's loss, each leaf's first-step gradient norm as its
optimizer state holds it, each sketched leaf's moment tables after the
first step (projected on seeded directions), and each leaf's change
after the checked steps (``perfbench/checks.py``).  ``failed`` counts
the window's steps whose loss is not finite.
"""
from __future__ import annotations

import gc
import inspect
import math
import time

import torch

from perfbench import checks, devtrace, project, traffic, weights
from perfbench.common import sub_seed
from perfbench.harness import Context, Outcome
from perfbench.model_config import port_config
from perfbench.reference import train as ref_train

PORT_DEFAULTS = ("b1", "b2", "eps", "weight_decay")


def _grad_norms(opt, names, b2: float):
    """Each leaf's first-step gradient norm from the optimizer's state:
    a count-min row of the second moment sums (1 - b2) g^2 of every
    element once (dense moments: their sum)."""
    out = {}
    for name, mo in zip(names, opt.moments):
        if hasattr(mo.v, "table"):
            s = mo.v.table.sum(dim=1).mean()
        else:
            s = sum(v.sum() for v in mo.v)
        out[name] = float(torch.sqrt(s / (1.0 - b2)))
    return out


def _moments(opt, names, seed):
    """Each sketched leaf's two moment tables, projected."""
    return {name: project.leaf_moments(mo.m.table, mo.v.table, seed, name)
            for name, mo in zip(names, opt.moments)
            if hasattr(mo.m, "table")}


def _deltas(conf, params, seed, device):
    """Each leaf's ||p - p0|| (float32), p0 the seed's weights."""
    from repro_torch.models.transformer import param_leaves
    pieces = dict(param_leaves(params))
    out = {}
    for lf in weights.leaves(conf):
        p0 = weights.make_leaf(lf, seed, device)
        rows = p0 if lf.layers else p0[None]
        sq = sum(float(torch.linalg.vector_norm(p.float() - r.float())) ** 2
                 for p, r in zip(pieces[lf.path], rows))
        out[lf.path] = math.sqrt(sq)
        del p0, rows
    return out


def run(ctx: Context) -> Outcome:
    from repro_torch.models import model as M
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sketch import optimizer as sko
    from repro_torch.train.optimizer import make_optimizer
    conf, mix, dev = ctx.conf, ctx.mix, ctx.device
    opt_spec = mix["optimizer"]
    sig = inspect.signature(sko.sketched_adamw_update).parameters
    for k in PORT_DEFAULTS:
        if k in sig and sig[k].default != opt_spec[k]:
            raise ValueError(f"the port's sketched AdamW runs {k} = "
                             f"{sig[k].default}, the mix asks {opt_spec[k]}")
    hash_seed = sub_seed(ctx.seed, "hash") % (1 << 31)
    cfg = port_config(conf, sketch=dict(
        opt_state_ratio=opt_spec["opt_state_ratio"],
        opt_state_rows=opt_spec["opt_state_rows"],
        opt_state_min_elems=opt_spec["opt_state_min_elems"], seed=hash_seed))
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    params = weights.port_params(conf, ctx.seed, dev)
    train_step = M.make_train_step(cfg)
    opt_init, opt_update = make_optimizer(cfg, lr=opt_spec["lr"])
    opt = opt_init(params)
    names = [n for n, _ in param_leaves(params)]
    timed = {"fwd_bwd_ms": [], "optimizer_ms": [], "step_s": []}

    def one_step(step: int, events: bool = False) -> float:
        tok = traffic.train_tokens(mix, conf["vocab_size"], ctx.seed, step,
                                   dev)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if events:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        loss, grads = train_step(params, batch)
        if events:
            ev[1].record()
        opt_update(grads, opt, params)
        if events:
            ev[2].record()
        del grads
        loss = float(loss)
        if events:
            timed["fwd_bwd_ms"].append(ev[0].elapsed_time(ev[1]))
            timed["optimizer_ms"].append(ev[1].elapsed_time(ev[2]))
        return loss

    n_check = mix["check"]["steps"]
    losses, grad_norms, moments = [], {}, {}
    for step in range(n_check):
        losses.append(one_step(step))
        if step == 0:
            grad_norms = _grad_norms(opt, names, opt_spec["b2"])
            moments = _moments(opt, names, ctx.seed)
    deltas = _deltas(conf, params, ctx.seed, dev)
    ctx.log(f"[train] checked steps: losses {losses}")

    prof = devtrace.Profile(ctx.trace and cuda)
    tr_steps = mix.get("trace", {}).get("steps", 0)
    events = ctx.trace and cuda
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    step, n = n_check, 0
    window_losses = []
    while True:
        if n == 1 and tr_steps:
            prof.start()
        ts = time.perf_counter()
        window_losses.append(one_step(step, events))
        if n == tr_steps and tr_steps:
            sync()
            prof.stop()
        elif n > tr_steps or n == 0:
            timed["step_s"].append(time.perf_counter() - ts)
        step += 1
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds and n > tr_steps:
            break
    t1 = time.perf_counter()
    window_s = t1 - t0
    tokens = n * mix["batch"] * mix["seq"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    moment_bytes = sko.moment_state_bytes(opt)["total"]
    ctx.log(f"[train] window: {n} steps in {window_s:.3f} s, setup "
            f"{setup_s:.3f} s, peak {peak} B")
    del params, opt, train_step, opt_update, opt_init
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = ref_train.run(conf, mix, ctx.seed, hash_seed, dev, n_check)
    ctx.log(f"[train] reference: {time.perf_counter() - t_ref:.3f} s, "
            f"losses {ref['losses']}")
    got = {"losses": losses, "grad_norms": grad_norms, "deltas": deltas,
           "moments": moments}
    found = checks.train_numbers(got, ref)
    notes = {}
    if ctx.readings:
        # the control: the reference in float8, in the program's place
        ctrl = ref_train.run(conf, mix, ctx.seed, hash_seed, dev, n_check,
                             precision="fp8")
        notes = {"control": checks.train_numbers(ctrl, ref),
                 "control_gaps": checks.train_gaps(ctrl, ref)}
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return Outcome(
        e2e={"train_tokens_per_s": tokens / window_s,
             "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        obs={"kind": "train", "conf": conf, "mix": mix, "steps": n,
             "window_s": window_s, **timed, "moment_bytes": moment_bytes,
             "profile": prof.summary, "profile_steps": tr_steps},
        checks=[(k, v, ctx.limits[k]) for k, v in found.items()],
        attempted=n,
        failed=sum(not math.isfinite(x) for x in window_losses),
        memory_peak_bytes=peak, profile=prof.summary,
        notes={**notes, "window_steps": n, "window_s": window_s,
               "window_losses": window_losses,
               "reference_s": time.perf_counter() - t_ref,
               "reference_parts_s": ref["seconds"],
               "reference_zero_v": ref["zero_v"],
               "gaps": checks.train_gaps(got, ref), "losses": losses,
               "reference_losses": ref["losses"]})
