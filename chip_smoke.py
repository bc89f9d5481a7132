"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
the sources in this checkout, holds each against its plain version,
checks the full-width model against its plain path, and serves
full-width gemma-2b through the port's main path.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. build     — nvcc for sm_90a, one process per source, all at once
  2. kernel    — paged attention vs its plain version at the decode,
                 chunked-prefill and a reduced (hd=16) geometry, with
                 kernel / plain / library (SDPA yardstick) times and the
                 bandwidth bound
  3. model     — full-width gemma-2b decode_step logits, kernel vs plain
  4. serve     — 16 requests through the async engine (the path
                 ServeEngine.generate wraps), launches counted, greedy
                 output checked against a teacher-forced recompute
The second-to-last line is the kernels' JSON record, the last line the
device record.  Imports nothing of JAX: the card's machine has none.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor rate
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, n: int, flush: torch.Tensor):
    """Device time of ``fn`` per call: the sum of the durations of the
    kernels it launches, from the profiler's CUPTI records, with the L2
    flushed before each call (the decode path reaches each layer's pool
    after other layers' weights have passed through the cache).  The
    flush's own kernel is left out by name.  Returns (ms per call,
    {kernel name: ms per call}, host wall ms per call)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "bitwise_not" in e.name:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / n
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    total = sum(by_name.values())
    if total <= 0:
        fail("the profiler recorded no device time")
    return total, by_name, wall


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

# name: (B, Sq, K, R, hd, NB, bs, nb)
GEOMETRIES = {
    "decode": (8, 1, 1, 8, 256, 256, 16, 32),
    "chunk_prefill": (1, 32, 1, 8, 256, 256, 16, 32),
    "reduced_hd16": (4, 1, 1, 4, 16, 24, 16, 6),
}


def paged_inputs(B, Sq, K, R, hd, NB, bs, nb, seed):
    """Ragged geometry as in tests/test_kernels.py: per-slot starts, slot
    0's last table entry invalidated, fold_base mixing 0 and bs."""
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, Sq, K, R, hd), dtype=torch.bfloat16)
    kp = torch.tensor(rng.randn(NB, bs, K, hd), dtype=torch.bfloat16)
    vp = torch.tensor(rng.randn(NB, bs, K, hd), dtype=torch.bfloat16)
    tables = (rng.permutation(NB)[:B * nb].reshape(B, nb) if B * nb <= NB
              else rng.randint(0, NB, (B, nb))).astype(np.int32)
    tables[0, nb - 1] = NB
    start = rng.randint(0, nb * bs - Sq, (B,)).astype(np.int32)
    fb = np.minimum(np.array([0] * (B - B // 2) + [bs] * (B // 2),
                             np.int32), start)
    ints = [torch.as_tensor(a) for a in (tables, start, fb)]
    return [t.cuda() for t in [q, kp, vp] + ints]


def live_keys(tables, start, fb, Sq, NB, bs):
    """Per slot: key positions some query row can see (data-dependent
    work of this run), and (row, key) pairs actually attended."""
    tb, st, f = (t.cpu().numpy() for t in (tables, start, fb))
    keys, pairs = 0, 0
    for b in range(tb.shape[0]):
        pos = np.arange(tb.shape[1] * bs)
        ok = (tb[b][pos // bs] < NB) & (pos >= f[b])
        keys += int((ok & (pos <= st[b] + Sq - 1)).sum())
        pairs += sum(int((ok & (pos <= st[b] + i)).sum()) for i in range(Sq))
    return keys, pairs


def sdpa_yardstick(q, kp, vp, tables, start, fb):
    """One library call computing the same attention: SDPA over the KV
    gathered dense with the same visibility mask (gather outside the
    timed call)."""
    B, Sq, K, R, hd = q.shape
    NB, bs = kp.shape[0], kp.shape[1]
    nb = tables.shape[1]
    idx = tables.clamp(max=NB - 1).long()
    kd = kp[idx].reshape(B, nb * bs, K, hd)
    vd = vp[idx].reshape(B, nb * bs, K, hd)
    kd = kd.repeat_interleave(R, dim=2).transpose(1, 2).contiguous()
    vd = vd.repeat_interleave(R, dim=2).transpose(1, 2).contiguous()
    qd = q.reshape(B, Sq, K * R, hd).transpose(1, 2).contiguous()
    pos = torch.arange(nb * bs, device=q.device)
    ok = (tables < NB).repeat_interleave(bs, dim=1)[:, None, :] \
        & (pos[None, None, :] >= fb[:, None, None]) \
        & (pos[None, None, :] <= start[:, None, None]
           + torch.arange(Sq, device=q.device)[None, :, None])
    mask = ok[:, None]                                   # (B,1,Sq,S)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                  attn_mask=mask)


def phase_kernel(flush):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    rows = {}
    for gi, (name, g) in enumerate(GEOMETRIES.items()):
        B, Sq, K, R, hd, NB, bs, nb = g
        args = paged_inputs(*g, seed=gi)
        m, l, acc = paged_attention(*args)
        torch.cuda.synchronize()
        mr, lr, ar = ref.paged_attention_ref(*args)
        ok_m = torch.allclose(m, mr, rtol=1e-5, atol=1e-6)
        ok_l = torch.allclose(l, lr, rtol=1e-4, atol=1e-6)
        out = acc / l.clamp(min=1e-30)[..., None]
        want = ar / lr.clamp(min=1e-30)[..., None]
        err = (out - want).abs().max().item()
        if not (ok_m and ok_l and err <= 2e-2) or not torch.isfinite(
                out).all():
            fail(f"paged_attention {name}: m ok {ok_m}, l ok {ok_l}, "
                 f"acc/l max err {err}")
        kernel_ms, parts, _ = device_ms(lambda: paged_attention(*args), 50,
                                        flush)
        kernel_only = sum(v for k, v in parts.items()
                          if "paged_attention_kernel" in k)
        plain_ms = device_ms(lambda: ref.paged_attention_ref(*args), 5,
                             flush)[0]
        library_ms = device_ms(sdpa_yardstick(*args), 50, flush)[0]
        keys, pairs = live_keys(args[3], args[4], args[5], Sq, NB, bs)
        NQ = R * Sq
        nbytes = (keys * K * hd * 2 * 2                  # live K and V
                  + B * Sq * K * R * hd * 2              # q
                  + B * K * NQ * (2 * 4 + hd * 4)        # m, l, acc
                  + 4 * (args[3].numel() + 2 * B))       # tables, st, fb
        flops = pairs * K * R * hd * 4                   # q.k and p.v
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        rows[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=err, bytes=nbytes, flops=flops)
        print(f"[kernel] paged_attention {name} {g}: max|acc/l err| "
              f"{err:.3e} (tol 2e-2; m rtol 1e-5, l rtol 1e-4 ok) "
              f"kernel_ms={kernel_ms:.5f} (kernel alone {kernel_only:.5f}, "
              f"the rest is the q transpose) plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} bound_ms={max(t_bytes, t_ops):.6f}"
              f" ({nbytes} B live, {flops} flop)")
    return rows


# ---------------------------------------------------------------------------
# phase 3: full-width model, kernel vs plain path
# ---------------------------------------------------------------------------


def phase_model(cfg, params, dev, flush):
    from repro_torch.models import transformer as tf
    B, NB, bs, nbs = 8, 256, 16, 32
    rng = np.random.RandomState(SEED + 1)
    cache = tf.init_paged_cache(cfg, NB, bs, dev)
    tables = torch.full((B, nbs), NB, dtype=torch.int32, device=dev)
    lens = rng.randint(1, 300, B)
    lens[0] = 0                                  # one idle slot
    nxt = 0
    for b in range(B):
        n = -(-(int(lens[b]) + 1) // bs)
        if lens[b] == 0:
            continue
        tables[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
        prompt = rng.randint(0, cfg.vocab_size, int(lens[b]))
        for off in range(0, int(lens[b]), 32):
            tok = np.zeros((1, 32), np.int64)
            seg = prompt[off:off + 32]
            tok[0, :len(seg)] = seg
            tf.prefill_chunk(params, cache, torch.as_tensor(tok, device=dev),
                             tables[b], off, cfg)
    pos = torch.as_tensor(lens.astype(np.int32), device=dev)
    cur = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, 1)),
                          device=dev)
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    lk, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables)
    lp, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables,
                           kernels=False)
    live = torch.as_tensor(lens > 0, device=dev)
    lk, lp = lk[live, :cfg.vocab_size], lp[live, :cfg.vocab_size]
    diff = (lk - lp).abs().max().item()
    tol = 0.03 * lp.abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    if not torch.isfinite(lk).all() or diff > tol or not bool(
            (lk.argmax(-1) == lp.argmax(-1))[sure].all()):
        fail(f"model parity: max|dlogit| {diff} (tol {tol}), greedy "
             f"agree {agree}/{int(live.sum())}")
    print(f"[model] gemma-2b full width decode_step, kernel vs plain: "
          f"max|dlogit| {diff:.4e} (tol {tol:.4e} = 3% of max|logit|), "
          f"greedy tokens agree {agree}/{int(live.sum())}")
    # where a decode step's time goes (8 slots, kernel path)
    c = clone(cache)
    busy, by_name, wall = device_ms(
        lambda: tf.decode_step(params, c, cur, pos, cfg, tables), 5, flush)
    pa = sum(v for k, v in by_name.items() if "paged_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] decode_step B=8: wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle), "
          f"paged_attention {pa:.4f} ms ({len(cfg and params['blocks'])} "
          f"launches); top kernels "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    return diff


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def phase_serve(cfg, params, dev, logit_gap):
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import make_request_stream, stream_requests
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    from repro_torch.serve.frontend import AsyncServeEngine
    serve = dataclasses.replace(cfg.serve, max_batch=8, max_seq=512,
                                kv_block_size=16, prefill_bucket=32,
                                decode_chunk=8, prefix_block=16)
    reqs = make_request_stream(cfg, np.random.RandomState(SEED + 2), 16, 3,
                               64, 192, 32, sampled_frac=0.25,
                               temperature=0.8, top_k=8)
    front = AsyncServeEngine(cfg, params, serve=serve, device=dev)
    torch.cuda.synchronize()
    paged_attention.launches = 0            # count the main path alone
    t0 = time.perf_counter()
    done, ttfts = asyncio.run(stream_requests(
        front, reqs, 0.0, 0.0, np.random.RandomState(SEED + 3)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    sched = front.scheduler
    st = sched.stats()
    held = sched.prefix_cache.held_blocks()
    leaked = sched.alloc.reserved - held
    while sched.prefix_cache.evict_one():
        pass
    leaked += sched.alloc.reserved
    ntok = sum(len(c.tokens) for c in done)
    ok = [c for c in done if c.status == "ok" and len(c.tokens) == 32
          and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
    if launches <= 0 or len(ok) != len(reqs) or leaked != 0 \
            or st.prefix_hits <= 0:
        fail(f"serve: launches {launches}, completed ok {len(ok)}/"
             f"{len(reqs)}, leaked blocks {leaked}, prefix hits "
             f"{st.prefix_hits}")
    # greedy output against a teacher-forced full-sequence recompute
    # (plain attention) on the served context: every served greedy token
    # must score within 3% of max|logit| of the recompute's top-1 (the
    # kernel-vs-plain tolerance of phase 3) at every step
    byrid = {r.rid: r for r in reqs}
    greedy = [c for c in done if not byrid[c.rid].temperature][:3]
    exact = total = 0
    worst = 0.0
    for c in greedy:
        r = byrid[c.rid]
        seq = torch.as_tensor(np.concatenate([r.tokens, c.tokens[:-1]]),
                              device=dev)[None]
        y, _ = tf.forward(params, tf.embed_inputs(params, seq), cfg)
        lg = ly.logits_fn(params, y[:, len(r.tokens) - 1:], cfg)[
            0, :, :cfg.vocab_size]
        got = lg.gather(1, torch.as_tensor(c.tokens, device=dev).long()[
            :, None])[:, 0]
        short = (lg.max(-1).values - got).max().item()
        tol = 0.03 * lg.abs().max().item()
        if short > tol:
            fail(f"serve: rid {c.rid} served a token {short} below the "
                 f"recompute's top-1 (tol {tol})")
        worst = max(worst, short / tol)
        exact += int((lg.argmax(-1).cpu().numpy() == c.tokens).sum())
        total += len(c.tokens)
    mean_chunk = float(np.mean(sched.chunk_ms))
    n_sampled = sum(1 for r in reqs if r.temperature)
    print(f"[serve] gemma-2b full width, 16 requests ({n_sampled} sampled): "
          f"{ntok} tokens in {wall:.4f}s = {ntok / wall:.2f} tok/s, "
          f"TTFT p50 {np.percentile(ttfts, 50) * 1e3:.2f} ms, mean decode "
          f"chunk {mean_chunk:.3f} ms ({len(sched.chunk_ms)} chunks of "
          f"{serve.decode_chunk} steps), peak reserved KV "
          f"{st.kv_peak_reserved_bytes} B, prefix hits {st.prefix_hits}/"
          f"{st.prefix_lookups}, leaked blocks 0, paged_attention launches "
          f"{launches}; greedy vs teacher-forced recompute: {exact}/{total} "
          f"tokens are its top-1, worst shortfall {worst:.2f} of tol; "
          f"{card()}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build.build_all()
    for name, (secs, log) in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {secs:.2f}s nvcc sm_90a {regs}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f}s on "
          f"{card()}")

    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = phase_kernel(flush)

    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=SEED, device=dev)
    gap = phase_model(cfg, params, dev, flush)
    del flush
    launches = phase_serve(cfg, params, dev, gap)

    d = rows["decode"]
    record = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:89",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"]}]}
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
