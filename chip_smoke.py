"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
the sources in this checkout, holds each against its plain version, runs
the paper's sketched CP decompositions and codecs at the paper's sizes,
checks the full-width model against its plain path, serves full-width
gemma-2b (at 512 and, sketched, at 8k context) and trains full-width
yi-9b through the port's main paths.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. build     — nvcc for sm_90a, one process per source, all at once
  2. kernel    — paged attention vs its plain version at the decode and
                 chunked-prefill geometries at max_seq 512 and 8192 and a
                 reduced (hd=16) one, with its split plan (blocks,
                 splits), two launches held bitwise equal, kernel / plain
                 / library (SDPA yardstick) times and the bandwidth
                 bound; sketch_update vs its plain version at
                 the reference's four kernel shapes, one yi-9b w_gate
                 layer piece whose indices pass 2^31 and the whole
                 48-piece w_gate leaf in one call: the estimates form's
                 tables and estimates, the fused form's tables, and its
                 params bitwise the plain path's from the same tables,
                 with both forms' times by kernel, the plain time and
                 the bounds
     kv        — tail_fold and tail_scores vs their plain versions at the
                 8k serve shapes (decode-chunk fold, prefill fold-through,
                 decode and chunked-prefill scores) and reduced shapes
                 with 2 and 4 hash rows, with kernel / plain / library
                 (index_add_ for the fold) times and the bound; the fold
                 also held bitwise to a row-by-row fold and to a second
                 launch, with its grid
     cs        — count_sketch and unsketch vs their plain versions at the
                 reference's six shapes, a bf16 case and the cpd path's
                 shapes (the CS oracle's 100 x 1,000,000 sketch and its
                 1 x 1,000,000 sketch of vec(T), Fig. 5's 2,400,000-entry
                 decompress, the FCS tiuu) and a J past the shared-memory
                 accumulators, with the branch each took, kernel / plain
                 / library (index_add_, index_select) times, the bound
                 and the bucket-link build time; count_sketch also held
                 bitwise to its tiled model and to a second launch
     cpd       — the paper core and CPD at the paper's sizes: Fig. 1 RTPM
                 (I 100, rank 10, D 2; plain held against the same run
                 on the CPU; TS and FCS at J 1000 / 4000 / 10000 with
                 every oracle call of a card run repeated on the CPU; CS
                 on vec(T) at J 10000 with three oracle calls held against
                 the plain version on the card), Table 2 (HCS vs FCS at
                 I 50, oracle calls repeated on the CPU), ALS (I 80, D 10,
                 30 sweeps; every MTTKRP call repeated on the CPU, plain
                 also as a whole run) and the Fig. 5 / 6 codecs at cr 2-16
                 (decompress kernel vs plain, error falling with cr); both
                 kernels launched, counted over the path's runs alone,
                 with their device time inside each run
  3. model     — full-width gemma-2b decode_step logits, kernel vs plain;
                 then sketched: a populated tail on most slots, kernel vs
                 plain, and slots that folded nothing equal to the
                 sketch-free step bitwise
  4. serve     — 16 requests through the async engine (the path
                 ServeEngine.generate wraps), launches counted, greedy
                 output checked against a teacher-forced recompute
     long      — gemma-2b at max_seq 8192 with sketched KV (window 1024,
                 ratio 8, rows 3): 8 requests of 512 to 6144 prompt
                 tokens and 64 new each through a pool of half their
                 rows; every request completes, no block leaks, rows
                 fold, and the tail kernels are launched on the path
  5. train     — yi-9b at full width and depth, 4 steps of batch 8 x 128
                 tokens with sketched AdamW (ratio 4, rows 3) through
                 train/loop.py; losses finite, sketch_update launched,
                 step 1's norm1 tables and params checked in situ against
                 the plain version from the step's own gradient (the
                 params bitwise from the kernel's tables); one profiled
                 step split by kernel, sketch_update's per step against
                 its bound
The second-to-last line is the kernels' JSON record, the last line the
device record.  Imports nothing of JAX: the card's machine has none.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
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
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor rate
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
    {kernel name: ms per call}, host wall ms per call).  A window in
    which the profiler delivered no kernel record at all (seen once on
    an H100, a 2-microsecond kernel after some 150 windows) is profiled
    once more, and a ``[profiler]`` line says so; a second empty window
    fails."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for window in range(2):
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
        if total > 0:
            if window:
                print(f"[profiler] the first window recorded no kernel; "
                      f"{total:.5f} ms from the second "
                      f"({', '.join(sorted(by_name))})")
            return total, by_name, wall
    fail("the profiler recorded no device time in two windows")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

# name: (B, Sq, K, R, hd, NB, bs, nb)
# decode and chunk prefill of the 512-token serve (nb 32) and of the 8k
# sketched serve (nb 512, starts drawn up to 8191), and a reduced one
GEOMETRIES = {
    "decode": (8, 1, 1, 8, 256, 256, 16, 32),
    "chunk_prefill": (1, 32, 1, 8, 256, 256, 16, 32),
    "reduced_hd16": (4, 1, 1, 4, 16, 24, 16, 6),
    "decode_8k": (8, 1, 1, 8, 256, 4096, 16, 512),
    "chunk_prefill_8k": (1, 256, 1, 8, 256, 4096, 16, 512),
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
    from repro_torch.kernels.paged_attention import (paged_attention, plan,
                                                     sm_count)
    rows = {}
    for gi, (name, g) in enumerate(GEOMETRIES.items()):
        B, Sq, K, R, hd, NB, bs, nb = g
        args = paged_inputs(*g, seed=gi)
        m, l, acc = paged_attention(*args)
        again = paged_attention(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((m, l, acc), again)):
            fail(f"paged_attention {name}: two launches differ")
        del again
        sms = sm_count(flush.device.index)
        pl = plan(B, K, R * Sq, nb, bs, sms)
        if name.startswith("decode") and pl.blocks < sms:
            fail(f"paged_attention {name}: {pl.blocks} blocks on {sms} SMs")
        mr, lr, ar = ref.paged_attention_ref(*args)
        ok_m = torch.allclose(m, mr, rtol=1e-5, atol=1e-6)
        ok_l = torch.allclose(l, lr, rtol=1e-4, atol=1e-6)
        out = acc / l.clamp(min=1e-30)[..., None]
        want = ar / lr.clamp(min=1e-30)[..., None]
        err = (out - want).abs().max().item()
        # p rounded to bf16 at another running max moves acc/l by a part
        # of its own size, and |acc/l| shrinks as more keys are visible
        # (about 0.02 at 8k): the limit scales with max|want|, capped at
        # 2e-2
        want_max = want.abs().max().item()
        want_mean = want.abs().mean().item()
        acc_tol = 2e-2 * min(1.0, want_max)
        if not (ok_m and ok_l and err <= acc_tol) or not torch.isfinite(
                out).all():
            fail(f"paged_attention {name}: m ok {ok_m}, l ok {ok_l}, "
                 f"acc/l max err {err} (tol {acc_tol})")
        kernel_ms, parts, _ = device_ms(lambda: paged_attention(*args), 50,
                                        flush)
        others = [k for k in parts if "paged_attention" not in k]
        if others:
            fail(f"paged_attention {name} launched other kernels: {others}")
        split_ms = sum(v for k, v in parts.items()
                       if "paged_attention_kernel" in k)
        plain_ms = device_ms(lambda: ref.paged_attention_ref(*args),
                             5 if nb <= 64 else 1, flush)[0]
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
        print(f"[kernel] paged_attention {name} {g}: grid {pl.blocks} "
              f"blocks ({pl.splits} splits of {pl.per_split} blocks, "
              f"{pl.tiles} tiles of {pl.tile_rows} rows); two launches "
              f"bitwise equal; max|acc/l err| "
              f"{err:.3e} (tol {acc_tol:.3e} = 2e-2 x min(1, max|acc/l| "
              f"{want_max:.4f}); mean|acc/l| {want_mean:.4f}; m rtol 1e-5, "
              f"l rtol 1e-4 ok) "
              f"kernel_ms={kernel_ms:.5f} (split kernel {split_ms:.5f}, "
              f"merge {kernel_ms - split_ms:.5f}; no other kernel) "
              f"plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} bound_ms={max(t_bytes, t_ops):.6f}"
              f" ({nbytes} B live, {flops} flop)")
    return rows


# name: (n, C, R, offset, gradient dtype[, pieces]).  The reference's four
# kernel shapes (tests/test_sketch_opt.py), then one layer piece of yi-9b's
# w_gate leaf (48 x 4096 x 11008; ratio 4, rows 3 -> C = 180,355,072):
# layer 47 at offset 47 * n, so its indices run to 2,164,260,863 > 2^31;
# last the whole leaf, its 48 layer pieces in one call (13 groups of the
# accumulate), as the train step makes it
SKETCH_GEOMETRIES = {
    "ref_1000": (1000, 300, 3, 0, torch.float32),
    "ref_4096": (4096, 512, 3, 0, torch.float32),
    "ref_700": (700, 128, 4, 0, torch.float32),
    "ref_8192": (8192, 640, 2, 0, torch.float32),
    "yi9b_w_gate_layer47": (45_088_768, 180_355_072, 3, 47 * 45_088_768,
                            torch.bfloat16),
    "yi9b_w_gate_leaf": (45_088_768, 180_355_072, 3, 0, torch.bfloat16, 48),
}
SKETCH_MAIN = "yi9b_w_gate_layer47"
B1, B2 = 0.9, 0.95
ADAMW = dict(lr=3e-4, eps=1e-8, weight_decay=0.01, bc1=0.1, bc2=0.05)
# the kernels of csrc/sketch_update.cu
SKETCH_KERNELS = ("bin_count_kernel", "bin_scan_kernel", "bin_offsets_kernel",
                  "bin_scatter_kernel", "slab_add_kernel", "apply_kernel",
                  "retrieve_kernel")


def sketch_kernel(name):
    """The sketch_update kernel a profiler record names, or None."""
    for k in SKETCH_KERNELS:
        if f"::{k}<" in name or f"::{k}(" in name:
            return k
    return None


def sketch_split(parts):
    """{sketch_update kernel: ms} of a device_ms parts dict."""
    out = {}
    for name, ms in parts.items():
        k = sketch_kernel(name)
        if k is not None:
            out[k] = out.get(k, 0.0) + ms
    return out


def close_to(got, want, what):
    """rtol 1e-5 and atol 1e-5 x max|want| (f32 shared-memory atomics add
    in a varying order; see csrc/sketch_update.cu).  Returns max |got -
    want|."""
    err = (got - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    bad = ((got - want).abs() > tol + 1e-5 * want.abs()).sum().item()
    if bad or not torch.isfinite(got).all():
        fail(f"{what}: {bad} entries outside tolerance, max err {err}")
    return err


def sketch_inputs(geo, dev, seed):
    """Pieces (g, offset), tables and coefficients of one geometry."""
    n, C, R, off, dt = geo[:5]
    npieces = geo[5] if len(geo) > 5 else 1
    gen = torch.Generator(dev).manual_seed(seed)
    pieces = [(torch.randn(n, generator=gen, device=dev).to(dt),
               off + k * n) for k in range(npieces)]
    m0 = torch.randn((R, C), generator=gen, device=dev)
    v0 = torch.randn((R, C), generator=gen, device=dev).abs_()
    from repro_torch.sketch.hashing import cached_coeffs
    cm = cached_coeffs(n + 3, R, device=dev)
    cv = cached_coeffs(n + 4, R, device=dev)
    return pieces, m0, v0, cm, cv


def phase_sketch_kernel(flush):
    """sketch_update at each geometry: the estimates form (tables and
    every piece's estimates vs the plain version) and the fused form
    (tables vs the plain version; from the tables it made, params bitwise
    the plain path's), then both forms timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sketch_update import (entry_bytes, plan_groups,
                                                   sketch_apply,
                                                   sketch_update)
    dev = flush.device
    rows = {}
    for gi, (name, geo) in enumerate(SKETCH_GEOMETRIES.items()):
        n, C, R, off, dt = geo[:5]
        pieces, m0, v0, cm, cv = sketch_inputs(geo, dev, SEED + gi)
        P = len(pieces)
        groups = len(plan_groups([n] * P, R, entry_bytes(dt)))
        # estimates form
        km, kv = m0.clone(), v0.clone()
        est = sketch_update(pieces, km, kv, cm, cv, b1=B1, b2=B2)
        rm, rv = ref.sketch_accumulate_ref(pieces, m0, v0, cm, cv, B1, B2)
        err = max(close_to(km, rm, f"sketch_update {name} new_m"),
                  close_to(kv, rv, f"sketch_update {name} new_v"))
        for (g, o), (mh, vh) in zip(pieces, est):
            rmh, rvh = ref.sketch_retrieve_ref(n, o, rm, rv, cm, cv)
            err = max(err, close_to(mh, rmh, f"sketch_update {name} m_hat"),
                      close_to(vh, rvh, f"sketch_update {name} v_hat"))
            del mh, vh, rmh, rvh
        del km, kv
        torch.cuda.empty_cache()
        # fused form: tables as above, params bitwise the plain path's
        # from the tables the kernel made
        gen = torch.Generator(dev).manual_seed(SEED + 40 + gi)
        params = [torch.randn(n, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(P)]
        start = [p.clone() for p in params]
        fm, fv = m0.clone(), v0.clone()
        sketch_apply(pieces, params, fm, fv, cm, cv, b1=B1, b2=B2, **ADAMW)
        err = max(err, close_to(fm, rm, f"sketch_apply {name} new_m"),
                  close_to(fv, rv, f"sketch_apply {name} new_v"))
        del rm, rv
        for (g, o), p, want in zip(pieces, params, start):
            mh, vh = ref.sketch_retrieve_ref(n, o, fm, fv, cm, cv)
            ref.sketched_leaf_update(want, mh, vh, **ADAMW)
            if not torch.equal(p, want):
                fail(f"sketch_apply {name}: params at offset {o} differ "
                     f"from the plain path's given the same tables, max "
                     f"{(p.float() - want.float()).abs().max().item()}")
            del mh, vh
        del start, fm, fv
        torch.cuda.empty_cache()
        reps = 2 if P > 1 else 5 if n > 1 << 20 else 50
        km, kv = m0.clone(), v0.clone()
        kernel_ms, parts, _ = device_ms(
            lambda: [None for _ in sketch_update(pieces, km, kv, cm, cv,
                                                 b1=B1, b2=B2)], reps, flush)
        apply_ms, aparts, _ = device_ms(
            lambda: sketch_apply(pieces, params, km, kv, cm, cv, b1=B1,
                                 b2=B2, **ADAMW), reps, flush)
        del km, kv
        torch.cuda.empty_cache()
        split = sketch_split(parts)
        asplit = sketch_split(aparts)
        if P == 1:
            g, o = pieces[0]
            plain_ms = device_ms(lambda: ref.sketch_update_ref(
                g, m0, v0, cm, cv, B1, B2, offset=o), 3 if reps == 5 else 10,
                flush)[0]
            plain_what = "sketch_update_ref"
        else:
            plain_ms = device_ms(lambda: ref.sketch_apply_ref(
                pieces, params, m0, v0, cm, cv, b1=B1, b2=B2, **ADAMW), 1,
                flush)[0]
            plain_what = "sketch_apply_ref, in place"
        del params
        torch.cuda.empty_cache()
        # bytes of the estimates form: g once, each table read and written
        # once (the scale counted once for the leaf), m_hat and v_hat
        # written once, the coefficients read once; of the fused form: g
        # once, the tables read and written once, the bf16 params read
        # and written once
        N = n * P
        nbytes = (N * dt.itemsize + 2 * 2 * R * C * 4 + 2 * N * 4
                  + 2 * R * 4 * 4)
        abytes = N * dt.itemsize + 2 * 2 * R * C * 4 + 2 * N * 2
        # f32 operations on these inputs: (1-b1)g, g^2, (1-b2)g^2; R adds
        # per table into the tables; 2 R C table scalings; the median
        # network's R(R-1)/2 compare pairs and the min's R-1 (the hashes
        # are integer work, for which the table of peaks has no rate)
        flops = N * (3 + 2 * R + R * (R - 1) + (R - 1)) + 2 * R * C
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        a_bound = max(abytes / HBM_BYTES_PER_S * 1e3, t_ops)
        rows[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            apply_ms=apply_ms, apply_bound_ms=a_bound,
            max_abs_err=err, bytes=nbytes, flops=flops)
        print(f"[kernel] sketch_update {name} (n={n} x {P} pieces, C={C}, "
              f"R={R}, offset={off}, g {str(dt)[6:]}, {groups} groups): "
              f"max|err| {err:.3e} (tol 1e-5 x max|ref| + 1e-5 rel; tables "
              f"and estimates); fused params bitwise the plain path's from "
              f"the same tables; estimates form kernel_ms={kernel_ms:.5f} ("
              + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
              + f"; the rest {max(0.0, kernel_ms - sum(split.values())):.5f})"
              f" "
              f"bound_ms={max(t_bytes, t_ops):.6f} ({nbytes} B, {flops} f32 "
              f"flop); fused form apply_ms={apply_ms:.5f} ("
              + ", ".join(f"{k} {v:.5f}" for k, v in asplit.items())
              + f") bound_ms={a_bound:.6f} ({abytes} B); plain_ms="
              f"{plain_ms:.5f} ({plain_what}) library_ms=null (no single "
              f"PyTorch call computes it)")
        del pieces, m0, v0
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2, kv: tail_fold and tail_scores vs their plain versions
# ---------------------------------------------------------------------------

# name: (G, N, Z, C, D).  The 8k serve shapes: the decode chunk folds
# fold_cap = 32 rows of 18 layers x 8 slots x k/v = 288 tables at its
# head; a slot's prefill fold-through folds prefill_fold_cap = 272 rows
# of 18 x k/v = 36 tables.  Then reduced shapes with even and odd Z, the
# counts ragged.
FOLD_GEOMETRIES = {
    "decode_fold": (288, 32, 3, 1024, 256),
    "prefill_fold": (36, 272, 3, 1024, 256),
    "reduced_z2": (12, 40, 2, 64, 32),
    "reduced_z4": (12, 40, 4, 64, 32),
}
# name: (B, K, N, hd, Z, C, T).  8k decode: 8 slots x 8 query heads of one
# kv head; chunked prefill: one slot's 256-token chunk x 8 heads.
SCORE_GEOMETRIES = {
    "decode_scores": (8, 1, 8, 256, 3, 1024, 8192),
    "chunk_scores": (1, 1, 2048, 256, 3, 1024, 8192),
    "reduced_z2": (2, 2, 6, 32, 2, 64, 512),
    "reduced_z4": (2, 1, 5, 32, 4, 64, 512),
}


def fold_inputs(G, N, Z, C, D, dev, seed, ragged):
    """Rows in bf16 (the pool's type), block-aligned consecutive positions
    per table below 8192, every row valid at the serve shapes."""
    gen = torch.Generator(dev).manual_seed(seed)
    rows = torch.randn((G, N, D), generator=gen, device=dev).to(
        torch.bfloat16)
    base = torch.randint(0, (8192 - N) // 16, (G, 1), generator=gen,
                         device=dev) * 16
    pos = (base + torch.arange(N, device=dev)).to(torch.int32)
    counts = (torch.randint(0, N + 1, (G,), generator=gen, device=dev)
              if ragged else torch.full((G,), N, device=dev)).to(torch.int32)
    tail = torch.randn((G, Z, C, D), generator=gen, device=dev)
    from repro_torch.sketch.hashing import cached_coeffs
    return rows, pos, counts, tail, cached_coeffs(seed + 7, Z, device=dev)


def phase_kv_kernels(flush):
    from repro_torch.kernels import ref
    from repro_torch.kernels.kv_sketch import FOLD_COLS, tail_fold, tail_scores
    from repro_torch.sketch.hashing import row_buckets_signs
    dev = flush.device
    fold_rows, score_rows = {}, {}
    for gi, (name, (G, N, Z, C, D)) in enumerate(FOLD_GEOMETRIES.items()):
        rows, pos, counts, tail, cf = fold_inputs(
            G, N, Z, C, D, dev, SEED + 20 + gi, name.startswith("reduced"))
        got, again, rowwise = tail.clone(), tail.clone(), tail.clone()
        tail_fold(rows, pos, counts, got, cf)
        tail_fold(rows, pos, counts, again, cf)
        torch.cuda.synchronize()
        ref.tail_fold_rowwise_ref(rows, pos, counts, rowwise, cf)
        if not (torch.equal(got, again) and torch.equal(got, rowwise)):
            fail(f"tail_fold {name}: not bitwise the row-by-row fold, or two "
                 f"launches differ")
        del again, rowwise
        want = tail.clone()
        ref.tail_fold_ref(rows, pos, counts, want, cf)
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        if not err <= tol or not torch.isfinite(got).all():
            fail(f"tail_fold {name}: max err {err} (tol {tol})")
        del want
        kernel_ms, parts, _ = device_ms(
            lambda: tail_fold(rows, pos, counts, got, cf), 50, flush)
        kernel_only = sum(v for k, v in parts.items() if "tail_fold" in k)
        scratch = tail.clone()
        plain_ms = device_ms(lambda: ref.tail_fold_ref(
            rows, pos, counts, scratch, cf), 10, flush)[0]
        del scratch
        # yardstick: one index_add_ of the signed rows into a contiguous
        # table at precomputed flat indices
        bk, sg = row_buckets_signs(cf, pos.reshape(-1), C, signed=True)
        valid = (torch.arange(N, device=dev)[None, :]
                 < counts[:, None]).reshape(1, -1)
        g = torch.arange(G, device=dev).repeat_interleave(N)[None, :]
        flat = ((g * Z + torch.arange(Z, device=dev)[:, None]) * C
                + bk)[valid.expand(Z, -1)]
        vals = (sg[:, :, None] * rows.reshape(1, G * N, D).float())[
            valid.expand(Z, -1)]
        table = tail.reshape(G * Z * C, D).clone()
        library_ms = device_ms(lambda: table.index_add_(0, flat, vals), 50,
                               flush)[0]
        # bytes: valid rows read once; each touched table row read and
        # written once; positions and counts read once
        n_valid = int(counts.sum())
        touched = int(torch.unique(flat).numel())
        nbytes = (n_valid * D * 2 + touched * D * 4 * 2 + G * N * 4 + G * 4)
        flops = n_valid * Z * D                       # one add per element
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        fold_rows[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=err)
        print(f"[kernel] tail_fold {name} (G={G}, N={N}, Z={Z}, C={C}, "
              f"D={D}, {n_valid} valid rows): grid "
              f"{G * Z * -(-D // FOLD_COLS)} "
              f"blocks; bitwise the row-by-row fold and a second launch; "
              f"max|err| {err:.3e} (tol "
              f"1e-5 x max|table| = {tol:.3e}) kernel_ms={kernel_ms:.5f} "
              f"(kernel alone {kernel_only:.5f}) plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} (index_add_) bound_ms="
              f"{max(t_bytes, t_ops):.6f} ({nbytes} B, {touched} table rows "
              f"touched, {flops} f32 flop)")
        del rows, pos, counts, tail, got, table, vals, flat
        torch.cuda.empty_cache()
    for gi, (name, (B, K, N, hd, Z, C, T)) in enumerate(
            SCORE_GEOMETRIES.items()):
        from repro_torch.sketch.hashing import cached_coeffs
        gen = torch.Generator(dev).manual_seed(SEED + 30 + gi)
        q = torch.randn((B, K, N, hd), generator=gen, device=dev)
        tk = torch.randn((B, Z, C, K, hd), generator=gen, device=dev)
        cf = cached_coeffs(SEED + 11, Z, device=dev)
        got = tail_scores(q, tk, cf, T)
        torch.cuda.synchronize()
        want = ref.tail_scores_ref(q, tk, cf, T)
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        if not err <= tol or not torch.isfinite(got).all():
            fail(f"tail_scores {name}: max err {err} (tol {tol})")
        del got, want
        kernel_ms, parts, _ = device_ms(lambda: tail_scores(q, tk, cf, T),
                                        50, flush)
        prod = sum(v for k, v in parts.items() if "products" in k)
        sel = sum(v for k, v in parts.items() if "select" in k)
        plain_ms = device_ms(lambda: ref.tail_scores_ref(q, tk, cf, T), 10,
                             flush)[0]
        # bytes: q and tail_k read once, the estimates written once;
        # operations: the bucket products on the tensor cores in 3xTF32,
        # three TF32 products for each f32 one (the gathers and medians
        # are compares and moves)
        nbytes = (q.numel() + tk.numel() + B * K * N * T) * 4 + Z * 16
        flops = 2 * B * K * Z * N * C * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 3 * flops / TF32_FLOPS * 1e3
        score_rows[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=err)
        print(f"[kernel] tail_scores {name} (B={B}, K={K}, N={N}, hd={hd}, "
              f"Z={Z}, C={C}, T={T}): max|err| {err:.3e} (tol 1e-4 x "
              f"max|est| = {tol:.3e}) kernel_ms={kernel_ms:.5f} (products "
              f"{prod:.5f}, select {sel:.5f}, other kernels "
              f"{max(0.0, kernel_ms - prod - sel):.5f}) plain_ms="
              f"{plain_ms:.5f} "
              f"library_ms=null (no single "
              f"PyTorch call computes it) bound_ms={max(t_bytes, t_ops):.6f}"
              f" ({nbytes} B, {flops} flop in 3xTF32 at "
              f"{TF32_FLOPS:.3g}/s)")
        del q, tk
        torch.cuda.empty_cache()
    return fold_rows, score_rows


# ---------------------------------------------------------------------------
# phase 2, cs: count_sketch and unsketch vs their plain versions
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
# name: (D, B, I, J, x dtype); D = 0 is one 1-D table (the reference's
# call).  The six shapes of tests/test_kernels.py and its bf16 case, then
# the cpd path's: the CS oracle's tiuu at Fig. 1 (the 100 rows of the
# (I, I^3) matrix, J 10000, D 2), its sketch of vec(T) (B 1,
# cpd/rtpm.py:cs_oracle) and the FCS tiuu's CS of 15 inits; last a J past
# the shared-memory accumulators (J-slabs)
CS_GEOMETRIES = {
    "ref_1x64_J32": (0, 1, 64, 32, F32),
    "ref_4x1000_J256": (0, 4, 1000, 256, F32),
    "ref_2x300_J64": (0, 2, 300, 64, F32),
    "ref_8x4096_J512": (0, 8, 4096, 512, F32),
    "ref_1x50_J300": (0, 1, 50, 300, F32),
    "ref_3x128_J128": (0, 3, 128, 128, F32),
    "ref_bf16_4x512_J128": (0, 4, 512, 128, BF16),
    "cs_tiuu_fig1": (2, 100, 1_000_000, 10_000, F32),
    "cs_vecT_fig1": (2, 1, 1_000_000, 10_000, F32),
    "fcs_tiuu_fig1": (2, 15, 100, 10_000, F32),
    "slabs_8x300000_J200000": (2, 8, 300_000, 200_000, F32),
}
CS_MAIN = "cs_tiuu_fig1"
# name: (D, B, I, J, y per repetition): the six reference shapes, then
# Fig. 5's decompress at cr 2 (the 2,400,000 entries of A (x) B read from
# 20 sketches of 1,199,997) and the FCS tiuu's lookup at Fig. 1
UNSKETCH_GEOMETRIES = {
    "ref_1x64_J32": (0, 1, 64, 32, False),
    "ref_4x1000_J256": (0, 4, 1000, 256, False),
    "ref_2x300_J64": (0, 2, 300, 64, False),
    "ref_8x4096_J512": (0, 8, 4096, 512, False),
    "ref_1x50_J300": (0, 1, 50, 300, False),
    "ref_3x128_J128": (0, 3, 128, 128, False),
    "kron_fig5_cr2": (20, 1, 2_400_000, 1_199_997, True),
    "fcs_tiuu_fig1": (2, 15, 100, 29_998, True),
}
UNSKETCH_MAIN = "kron_fig5_cr2"


def cs_tables(D, I, J, dev, gen):
    shape = (I,) if D == 0 else (D, I)
    h = torch.randint(0, J, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    s = 1.0 - 2.0 * torch.randint(0, 2, shape, generator=gen, device=dev,
                                  dtype=torch.int32).float()
    return h, s


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_cs_kernels(flush):
    from repro_torch.kernels import ref
    from repro_torch.kernels.count_sketch import (bucket_links, count_sketch,
                                                  plan, unsketch)
    dev = flush.device
    cs_rows, un_rows = {}, {}
    for gi, (name, (D, B, I, J, dt)) in enumerate(CS_GEOMETRIES.items()):
        gen = torch.Generator(dev).manual_seed(SEED + 40 + gi)
        x = torch.randn((B, I), generator=gen, device=dev).to(dt)
        h, s = cs_tables(D, I, J, dev, gen)
        idx = bucket_links(h, s, J)
        Dn = max(D, 1)
        branch = plan(Dn, B, I, J, x.element_size()).branch
        got = count_sketch(x, h, s, J, idx)
        torch.cuda.synchronize()
        want = ref.count_sketch_ref(x, h, s, J)
        err = (got.float() - want.float()).abs().max().item()
        rel = 1e-5 if dt == F32 else 2 ** -7       # bf16: one rounding
        tol = rel * want.float().abs().max().item()
        if not err <= tol or not torch.isfinite(got).all() \
                or not torch.equal(got, count_sketch(x, h, s, J, idx)):
            fail(f"count_sketch {name}: max err {err} (tol {tol}), or two "
                 f"launches differ")
        if not torch.equal(got, ref.count_sketch_tiled_ref(x, h, s, J)):
            fail(f"count_sketch {name}: not bitwise its tiled model")
        del got, want
        big = I * B > 1 << 24
        index_ms = device_ms(lambda: bucket_links(h, s, J), 10, flush)[0]
        kernel_ms = device_ms(lambda: count_sketch(x, h, s, J, idx),
                              10 if big else 50, flush)[0]
        plain_ms = device_ms(lambda: ref.count_sketch_ref(x, h, s, J),
                             3 if big else 10, flush)[0]
        # yardstick: one index_add_ of precomputed s.x at the flat bucket
        # of every (repetition, i) into a zeroed (B, D J)
        h2, s2 = h.reshape(Dn, I), s.reshape(Dn, I)
        flat = (h2.long() + J * torch.arange(Dn, device=dev)[:, None]
                ).reshape(-1)
        sx = torch.cat([x.float() * s2[d] for d in range(Dn)], dim=1)
        table = torch.zeros((B, Dn * J), device=dev)
        library_ms = device_ms(lambda: table.index_add_(1, flat, sx),
                               10 if big else 50, flush)[0]
        del sx, table, flat
        esize = x.element_size()
        # bytes: x, h and s read once, the output written once; f32
        # operations: one add per element and repetition
        nbytes = B * I * esize + Dn * I * 8 + Dn * B * J * esize
        bms, by = bound(nbytes, Dn * B * I)
        cs_rows[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bms,
                             bound_by=by, max_abs_err=err)
        print(f"[cs] count_sketch {name} (D={D}, B={B}, I={I}, J={J}, x "
              f"{str(dt)[6:]}; {branch}): max|err| {err:.3e} (tol {rel:g} x "
              f"max|out| = {tol:.3e}; bitwise its tiled model and a second "
              f"launch) kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} (index_add_) bound_ms="
              f"{bms:.6f} ({by}, {nbytes} B) bucket links build "
              f"{index_ms:.5f} ms")
        del x, h, s, idx
        torch.cuda.empty_cache()
    for gi, (name, (D, B, I, J, per_row)) in enumerate(
            UNSKETCH_GEOMETRIES.items()):
        gen = torch.Generator(dev).manual_seed(SEED + 50 + gi)
        Dn = max(D, 1)
        y = torch.randn(((Dn,) if per_row else ()) + (B, J), generator=gen,
                        device=dev)
        h, s = cs_tables(D, I, J, dev, gen)
        got = unsketch(y, h, s)
        torch.cuda.synchronize()
        want = ref.unsketch_ref(y, h, s)
        if not torch.equal(got, want):
            fail(f"unsketch {name}: not bitwise equal to the plain version "
                 f"(max err {(got - want).abs().max().item()})")
        del got, want
        big = Dn * I > 1 << 24
        kernel_ms = device_ms(lambda: unsketch(y, h, s), 10 if big else 50,
                              flush)[0]
        plain_ms = device_ms(lambda: ref.unsketch_ref(y, h, s),
                             3 if big else 10, flush)[0]
        # yardstick: one index_select of y at every repetition's flat
        # bucket, without the sign
        h2 = h.reshape(Dn, I).long()
        if per_row:
            ys = y.permute(1, 0, 2).reshape(B, Dn * J).contiguous()
            flat = (h2 + J * torch.arange(Dn, device=dev)[:, None]
                    ).reshape(-1)
        else:
            ys, flat = y, h2.reshape(-1)
        library_ms = device_ms(lambda: torch.index_select(ys, 1, flat),
                               10 if big else 50, flush)[0]
        del ys, flat, h2
        # bytes: tables read once, y read once, the output written once
        nbytes = (Dn * I * 8 + Dn * B * I * 4
                  + (Dn if per_row else 1) * B * J * 4)
        bms, by = bound(nbytes, 0)
        un_rows[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bms,
                             bound_by=by, max_abs_err=0.0)
        print(f"[cs] unsketch {name} (D={D}, B={B}, I={I}, J={J}, y "
              f"{'per repetition' if per_row else 'shared'}; "
              f"{'vector' if I % 4 == 0 else 'scalar'} loads): bitwise equal "
              f"to the plain version kernel_ms={kernel_ms:.5f} plain_ms="
              f"{plain_ms:.5f} library_ms={library_ms:.5f} (index_select) "
              f"bound_ms={bms:.6f} ({by}, {nbytes} B)")
        del y, h, s
        torch.cuda.empty_cache()
    return cs_rows, un_rows


# ---------------------------------------------------------------------------
# phase 2, cpd: the paper core and CP decomposition at the paper's sizes
# ---------------------------------------------------------------------------


CS_KERNELS = ("count_sketch_kernel", "combine_kernel", "unsketch_kernel")


def traced(fn):
    """Run ``fn`` once under a CUDA-only profiler (CUPTI kernel records):
    (result, wall s ending in a synchronize, device busy s, {kernel:
    (device s, records)} for the count-sketch source's kernels).  The
    kernel durations are summed from the raw records: building the
    profiler's event tree costs tens of microseconds of host time per
    record, and a CS decomposition launches tens of thousands of
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, mine = 0.0, {k: [0.0, 0] for k in CS_KERNELS}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        sec = e.duration_ns() / 1e9
        busy += sec
        for k in CS_KERNELS:
            if k in e.name():
                mine[k][0] += sec
                mine[k][1] += 1
    if busy <= 0:
        fail("the profiler recorded no device time in a cpd run")
    return out, wall, busy, mine


def kernel_time(mine):
    """The count-sketch source's device time in one traced run."""
    return ", ".join(f"{k} {sec:.4f}s in {n}" + (
        f" ({1e3 * sec / n:.5f} ms each)" if n else "")
        for k, (sec, n) in mine.items())


def on_card(hashes, dev):
    """The same hashes tabulated on the card from their coefficients."""
    from repro_torch.core import ModeHash, mode_hash_from_coeffs
    if isinstance(hashes, ModeHash):
        return mode_hash_from_coeffs(hashes.coeffs, hashes.I, hashes.J, dev)
    return tuple(on_card(mh, dev) for mh in hashes)


class Shadow:
    """Repeats every oracle call the card makes on the CPU plain path at
    the same input.  Each must agree within 1e-4 x max|CPU value| +
    1e-6 x ||T||_F x the product of the input vectors' norms: an f32 FFT
    correlation's rounding error scales with the norms of what it
    correlates, not with its output, which cancels to far below them when
    the sketch holds little signal.  This holds the card to the CPU along
    the card's own trajectory.  A sketched run is not held to a whole CPU
    run: power iteration and ALS on a sketch amplify rounding, so two
    rounding orders of the same run part by far more than 1e-3."""

    def __init__(self, what, T_norm):
        self.what, self.T_norm, self.calls, self.worst = what, T_norm, 0, 0.0

    def wrap(self, card_fn, cpu_fn, n_vec):
        """``n_vec(args)``: the product of the input vectors' norms."""
        def fn(*args):
            out = card_fn(*args)
            want = cpu_fn(*(a.cpu() if torch.is_tensor(a) else a
                            for a in args))
            err = (out.cpu() - want).abs().max().item()
            tol = (1e-4 * want.abs().max().item()
                   + 1e-6 * self.T_norm * n_vec(args))
            if not err <= tol:
                fail(f"{self.what}: oracle call {self.calls} card vs CPU max "
                     f"err {err} (tol {tol})")
            self.calls += 1
            self.worst = max(self.worst, err / tol)
            return out
        return fn

    def rtpm(self, T, T_cpu, method, hc, hashes, I, R, L, T_iters, inits,
             dev):
        """RTPM on the card with every oracle call shadowed; a note."""
        from repro_torch.cpd.rtpm import make_oracle, rtpm
        k_or = make_oracle(T, method, hc)
        c_or = make_oracle(T_cpu, method, hashes)
        rtpm(*(self.wrap(k, c, lambda a, p=p: vec_norm(a[0], p))
               for k, c, p in zip(k_or, c_or, (2, 3))), I, R,
             n_inits=L, n_iters=T_iters, inits=inits, device=dev)
        return (f"{self.calls} oracle calls of a card run repeated on the "
                f"CPU within tol (worst {self.worst:.3f} of tol)")


def vec_norm(u, power):
    """max over the rows of u of ||u_row||^power."""
    return u.norm(dim=-1).max().item() ** power


def whole_run(what, card_l, card_res, cpu_l, cpu_res):
    """A plain run, card vs CPU from the same inits: lambdas within
    1e-3 x max|lambda|, residuals within 1e-3."""
    tol = 1e-3 * cpu_l.abs().max().item()
    dl = (card_l.cpu() - cpu_l).abs().max().item()
    dr = max(abs(a - b) for a, b in zip(card_res, cpu_res))
    if not (dl <= tol and dr <= 1e-3):
        fail(f"{what}: card vs CPU max|dlambda| {dl} (tol {tol}), max "
             f"|dresidual| {dr} (tol 1e-3)")
    return (f"whole run card vs CPU max|dlambda| {dl:.3e}, max|dresidual| "
            f"{dr:.3e} (tol 1e-3 x max|lambda| / 1e-3)")


def phase_cpd(dev):
    from repro_torch.core import (fcs_contraction_compress,
                                  fcs_contraction_decompress,
                                  fcs_kron_compress, fcs_kron_decompress,
                                  fcs_sketch_len, make_tensor_hashes,
                                  storage_bytes_cs_long,
                                  storage_bytes_tabulated)
    from repro_torch.cpd import als
    from repro_torch.cpd.rtpm import make_oracle, rtpm_hashes
    from repro_torch.kernels.count_sketch import count_sketch, unsketch
    from repro_torch.launch.cpd import (FIG1, decompose, hash_bytes,
                                        residuals, symmetric_tensor)
    t_phase = time.perf_counter()
    launches = dict(count_sketch=0, unsketch=0)
    line = dict(launches)
    line_dev = {k: [0.0, 0] for k in CS_KERNELS}

    def path(fn):
        """One run of the cpd path under ``traced``.  The counts go to 0
        just before it and are added up just after, so the checks' own
        launches between the path's runs are not counted."""
        count_sketch.launches = unsketch.launches = 0
        *out, mine = traced(fn)
        for name, n in (("count_sketch", count_sketch.launches),
                        ("unsketch", unsketch.launches)):
            launches[name] += n
            line[name] += n
        for k, (sec, n) in mine.items():
            line_dev[k][0] += sec
            line_dev[k][1] += n
        return tuple(out)

    def line_launches():
        """The path's launches since the last call, for a line."""
        text = (f"path launches count_sketch {line['count_sketch']}, "
                f"unsketch {line['unsketch']}; in-run device time "
                f"{kernel_time(line_dev)}")
        line.update(count_sketch=0, unsketch=0)
        line_dev.update({k: [0.0, 0] for k in CS_KERNELS})
        return text

    gen = torch.Generator().manual_seed(SEED + 60)
    I, R, D, L, T = (FIG1[k] for k in ("I", "R", "D", "L", "T"))
    Tn_cpu, Tc_cpu = symmetric_tensor(I, R, FIG1["sigma"], gen, "cpu")
    Tn, Tc = Tn_cpu.to(dev), Tc_cpu.to(dev)
    finite = []
    for method, J in FIG1["runs"]:
        t_block = time.perf_counter()
        hashes = rtpm_hashes(I, method, J, D, gen, "cpu")
        inits = torch.randn((R, L, I), generator=gen)
        hc = None if hashes is None else on_card(hashes, dev)
        (lams, U, _), wall, busy = path(lambda: decompose(
            Tn, R, method, J, D, L, T, gen, hashes=hc, inits=inits))
        res = residuals(Tn, Tc, lams, U)
        finite.append(torch.isfinite(lams).all() and torch.isfinite(U).all())
        if method == "plain":
            lc, Uc, sec_c = decompose(Tn_cpu, R, method, J, D, L, T, gen,
                                      inits=inits)
            note = (whole_run(f"fig1 {method}", lams, res, lc,
                              residuals(Tn_cpu, Tc_cpu, lc, Uc))
                    + f"; CPU run {sec_c:.2f}s")
        elif method in ("ts", "fcs"):
            note = Shadow(f"fig1 {method} J={J}", Tn_cpu.norm().item()).rtpm(
                Tn, Tn_cpu, method, hc, hashes, I, R, L, T, inits, dev)
        else:
            k_tiuu, k_tuuu = make_oracle(Tn, "cs", hc)
            p_tiuu, p_tuuu = make_oracle(Tn, "cs", hc, use_kernel=False)
            worst, T_norm = 0.0, Tn.norm().item()
            for k in range(3):
                u = torch.randn(I, generator=gen).to(dev)
                u = u / u.norm()
                for kf, pf in ((k_tiuu, p_tiuu), (k_tuuu, p_tuuu)):
                    got, want = kf(u), pf(u)
                    e = (got - want).abs().max().item()
                    # as in Shadow: unit u, so ||T||_F is the sums' scale
                    tol = 1e-4 * want.abs().max().item() + 1e-6 * T_norm
                    if not e <= tol:
                        fail(f"fig1 cs oracle call {k}: kernel vs plain max "
                             f"err {e} (tol {tol})")
                    worst = max(worst, e / tol)
            note = (f"3 tiuu + 3 tuuu calls kernel vs use_kernel=False on "
                    f"the card within 1e-4 x max + 1e-6 x ||T|| (worst "
                    f"{worst:.3f} of tol)")
        print(f"[cpd] fig1 rtpm {method} J={J} (I={I}, R={R}, D={D}, L={L}, "
              f"T={T}): residual {res[0]:.4f} observed, {res[1]:.4f} clean; "
              f"lambda {lams.min().item():.4f}..{lams.max().item():.4f}; "
              f"hash bytes {hash_bytes(method, I, J, D)}; {wall:.3f}s, device "
              f"busy {busy:.3f}s ({100 * (1 - busy / wall):.1f}% idle); "
              f"{line_launches()}; {note}; line's work "
              f"{time.perf_counter() - t_block:.2f}s")
        del hashes, hc
        torch.cuda.empty_cache()
    # Table 2: HCS vs FCS at matched sketched dimension, I = 50
    Tn2_cpu, Tc2_cpu = symmetric_tensor(50, R, FIG1["sigma"], gen, "cpu")
    Tn2, Tc2 = Tn2_cpu.to(dev), Tc2_cpu.to(dev)
    for J2, D2 in ((300, 10), (300, 20)):
        J1 = max(4, round((3 * J2 - 2) ** (1 / 3)))
        for method, J in (("hcs", J1), ("fcs", J2)):
            t_block = time.perf_counter()
            hashes = rtpm_hashes(50, method, J, D2, gen, "cpu")
            inits = torch.randn((R, L, 50), generator=gen)
            hc = on_card(hashes, dev)
            (lams, U, _), wall, busy = path(lambda: decompose(
                Tn2, R, method, J, D2, L, T, gen, hashes=hc, inits=inits))
            res = residuals(Tn2, Tc2, lams, U)
            finite.append(torch.isfinite(lams).all())
            note = Shadow(f"table2 {method} J={J} D={D2}",
                          Tn2_cpu.norm().item()).rtpm(
                Tn2, Tn2_cpu, method, hc, hashes, 50, R, L, T, inits, dev)
            print(f"[cpd] table2 rtpm {method} J={J} D={D2} (I=50, R={R}): "
                  f"residual {res[0]:.4f} observed, {res[1]:.4f} clean; "
                  f"hash bytes {hash_bytes(method, 50, J, D2)}; {wall:.3f}s, "
                  f"device busy {busy:.3f}s ({100 * (1 - busy / wall):.1f}% "
                  f"idle); {line_launches()}; {note}; line's work "
                  f"{time.perf_counter() - t_block:.2f}s")
    # ALS (benchmarks/bench_als.py defaults): I 80, R 10, D 10, 30 sweeps
    Ia, Da, iters = 80, 10, 30
    F0 = [torch.linalg.qr(torch.randn((Ia, Ia), generator=gen))[0][:, :R]
          for _ in range(3)]
    Tc3 = torch.einsum("ar,br,cr->abc", *F0)
    Tn3 = Tc3 + FIG1["sigma"] * torch.randn((Ia,) * 3, generator=gen)

    def als_res(T_obs, T_clean, lam, F):
        Rm = torch.einsum("r,ar,br,cr->abc", lam, *F)
        return tuple(float((Tx - Rm).norm() / Tx.norm())
                     for Tx in (T_obs, T_clean))
    for method, J in (("plain", 0), ("ts", 1500), ("ts", 3000),
                      ("fcs", 1500), ("fcs", 3000)):
        t_block = time.perf_counter()
        inits = als.als_inits(Tn3, R, gen)
        hashes = (None if method == "plain" else make_tensor_hashes(
            Tn3.shape, J, Da, gen, "cpu"))
        on = dict(method=method, n_iters=iters)
        Tg, Tcg = Tn3.to(dev), Tc3.to(dev)
        hg = None if hashes is None else on_card(hashes, dev)
        ig = [tuple(f.to(dev) for f in i) for i in inits]
        (lam, F), wall, busy = path(lambda: als.als_decompose(
            Tg, R, inits=ig, hashes=hg, **on))
        res = als_res(Tg, Tcg, lam, F)
        shadow = Shadow(f"als {method} J={J}", Tn3.norm().item())
        als.als_fit(Tg, R, shadow.wrap(
            als.make_mttkrp(Tg, method, hg),
            als.make_mttkrp(Tn3, method, hashes),
            lambda a: vec_norm(a[0].T, 1) * vec_norm(a[1].T, 1)), ig, iters)
        note = ""
        if method == "plain":
            t0 = time.perf_counter()
            lc, Fc = als.als_decompose(Tn3, R, inits=inits, **on)
            note = ("; " + whole_run(f"als {method}", lam, res, lc,
                                     als_res(Tn3, Tc3, lc, Fc))
                    + f"; CPU run {time.perf_counter() - t0:.2f}s")
        finite.append(torch.isfinite(lam).all())
        print(f"[cpd] als {method} J={J} (I={Ia}, R={R}, D={Da}, {iters} "
              f"sweeps, 3 inits probed): residual {res[0]:.4f} observed, "
              f"{res[1]:.4f} clean; hash bytes "
              f"{0 if hashes is None else storage_bytes_tabulated(hashes)}; "
              f"{wall:.3f}s, device busy {busy:.3f}s "
              f"({100 * (1 - busy / wall):.1f}% idle); {line_launches()}; "
              f"{shadow.calls} mttkrp "
              f"calls of a card run repeated on the CPU within tol (worst "
              f"{shadow.worst:.3f} of it){note}; line's work "
              f"{time.perf_counter() - t_block:.2f}s")
    # Figs. 5 and 6: Kronecker-product and mode-contraction codecs, D = 20
    for fig, shA, shB, lo, hi in (("fig5 kron", (30, 40), (40, 50), -5.0,
                                   5.0),
                                  ("fig6 contraction", (30, 40, 50),
                                   (50, 40, 30), 0.0, 10.0)):
        kron = fig.startswith("fig5")
        A = (lo + (hi - lo) * torch.rand(shA, generator=gen)).to(dev)
        B = (lo + (hi - lo) * torch.rand(shB, generator=gen)).to(dev)
        full = (torch.kron(A, B) if kron
                else torch.einsum("abl,lcd->abcd", A, B))
        dims = shA + shB if kron else (30, 40, 40, 30)
        errs = {}
        for cr in (2, 4, 8, 16):
            t_block = time.perf_counter()
            Jt = max(8, full.numel() // cr)
            J = max(2, (Jt + 3) // 4)
            Jt = fcs_sketch_len([J] * 4)
            hashes = make_tensor_hashes(dims, J, 20, gen, dev)
            comp = fcs_kron_compress if kron else fcs_contraction_compress
            sk, c_wall, c_busy = path(lambda: comp(A, B, hashes))

            def dec(use_kernel=None):
                if kron:
                    return fcs_kron_decompress(sk, hashes, shA, shB,
                                               use_kernel)
                return fcs_contraction_decompress(sk, hashes, dims,
                                                  use_kernel)
            est, d_wall, d_busy = path(dec)
            plain = dec(use_kernel=False)
            e = (est - plain).abs().max().item()
            tol = 1e-6 * plain.abs().max().item()
            if not e <= tol or not torch.isfinite(est).all():
                fail(f"{fig} cr {cr}: decompress kernel vs plain max err "
                     f"{e} (tol {tol})")
            errs[cr] = float((est - full).norm() / full.norm())
            print(f"[cpd] {fig} cr {cr} (J={J}, J~={Jt}, D=20): rel err "
                  f"{errs[cr]:.4f}; hash bytes "
                  f"{storage_bytes_tabulated(hashes)} (CS on the "
                  f"{full.numel()}-entry result: "
                  f"{storage_bytes_cs_long(dims, 20)}); compress "
                  f"{c_wall:.4f}s ({100 * (1 - c_busy / c_wall):.1f}% idle), "
                  f"decompress {d_wall:.4f}s "
                  f"({100 * (1 - d_busy / d_wall):.1f}% idle), kernel vs "
                  f"use_kernel=False max err {e:.3e} (tol 1e-6 x max); "
                  f"{line_launches()}; "
                  f"line's work {time.perf_counter() - t_block:.2f}s")
            del sk, est, plain, hashes
            torch.cuda.empty_cache()
        if not errs[2] < errs[16]:
            fail(f"{fig}: rel err at cr 2 {errs[2]} not below cr 16 "
                 f"{errs[16]}")
    if not all(bool(f) for f in finite) or min(launches.values()) <= 0:
        fail(f"cpd: finite {all(bool(f) for f in finite)}, launches "
             f"{launches}")
    print(f"[cpd] launches on the cpd path {launches}; phase "
          f"{time.perf_counter() - t_phase:.2f}s; {card()}")
    return launches


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


LONG = dict(max_seq=8192, window=1024, ratio=8, rows=3)


def phase_sketch_model(cfg, params, dev, flush):
    """Full-width sketched decode_step: slots 1-6 hold a tail folded from
    their first rows, slot 7 holds a context but folded nothing, slot 0 is
    idle.  Kernel path vs plain path on identical caches, and the slots
    with fold_base == 0 against the sketch-free kernel step, bitwise."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_sketch as kvs
    B, NB, bs = 8, 1024, 16
    nbs = LONG["max_seq"] // bs
    Z = LONG["rows"]
    C = kvs.tail_cols(LONG["max_seq"], LONG["ratio"])
    T = kvs.pos_domain(LONG["max_seq"], bs)
    rng = np.random.RandomState(SEED + 4)
    cache = tf.init_paged_cache(cfg, NB, bs, dev, tail=(B, Z, C))
    tables = torch.full((B, nbs), NB, dtype=torch.int32, device=dev)
    lens = rng.randint(1100, 1900, B)
    lens[0] = 0                                  # one idle slot
    fb = np.array([0] + [int(rng.randint(8, 50)) * bs for _ in range(6)]
                  + [0], np.int32)
    nxt = 0
    for b in range(1, B):
        n = -(-(int(lens[b]) + 1) // bs)
        tables[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
        prompt = rng.randint(0, cfg.vocab_size, int(lens[b]))
        for off in range(0, int(lens[b]), 256):
            tok = np.zeros((1, 256), np.int64)
            seg = prompt[off:off + 256]
            tok[0, :len(seg)] = seg
            tf.prefill_chunk(params, cache, torch.as_tensor(tok, device=dev),
                             tables[b], off, cfg)
    sv = dataclasses.replace(cfg.serve, kv_sketch_rows=Z)
    coeffs = kvs.tail_coeffs(sv, device=dev)
    fold_base = torch.as_tensor(fb, device=dev)
    kvs.fold_pool(cache["kv"], cache["tail"], tables,
                  torch.zeros_like(fold_base), fold_base, coeffs,
                  int(fb.max()))
    pos = torch.as_tensor(lens.astype(np.int32), device=dev)
    cur = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, 1)),
                          device=dev)
    sk = {"fold_base": fold_base, "tail": cache["tail"], "coeffs": coeffs,
          "pos_hash": kvs.pos_buckets_signs(coeffs, T, C)}
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    lk, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables,
                           sketch=sk)
    lp, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables,
                           kernels=False, sketch=sk)
    l0, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables)
    anchor = torch.as_tensor(fb == 0, device=dev)
    if not torch.equal(lk[anchor], l0[anchor]):
        fail("sketched model: slots with fold_base == 0 differ from the "
             "sketch-free step")
    live = torch.as_tensor(lens > 0, device=dev)
    lk, lp = lk[live, :cfg.vocab_size], lp[live, :cfg.vocab_size]
    diff = (lk - lp).abs().max().item()
    tol = 0.03 * lp.abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    if not torch.isfinite(lk).all() or diff > tol or not bool(
            (lk.argmax(-1) == lp.argmax(-1))[sure].all()):
        fail(f"sketched model parity: max|dlogit| {diff} (tol {tol}), "
             f"greedy agree {agree}/{int(live.sum())}")
    moved = (l0[live, :cfg.vocab_size] - lk).abs().max().item()
    print(f"[model] gemma-2b full width sketched decode_step (fold_base "
          f"{fb.tolist()}, contexts {lens.tolist()}), kernel vs plain: "
          f"max|dlogit| {diff:.4e} (tol {tol:.4e} = 3% of max|logit|), "
          f"greedy agree {agree}/{int(live.sum())}; fold_base == 0 slots "
          f"bitwise equal to the sketch-free step; the tail moved the "
          f"folded slots' logits by up to {moved:.4e}")
    c = clone(cache)
    busy, by_name, wall = device_ms(
        lambda: tf.decode_step(params, c, cur, pos, cfg, tables, sketch=sk),
        5, flush)
    pa = sum(v for k, v in by_name.items() if "paged_attention" in k)
    ts = sum(v for k, v in by_name.items() if "scores_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] sketched decode_step B=8, T={T}: wall {wall:.3f} "
          f"ms/step, device busy {busy:.3f} ms ({100 * (1 - busy / wall):.1f}"
          f"% idle), paged_attention {pa:.4f} ms, tail_scores {ts:.4f} ms; "
          f"top kernels " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    del cache, c
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def greedy_shortfall(params, cfg, dev, prompt, toks):
    """Per served greedy token, how far its exact teacher-forced logit
    falls below the exact recompute's top-1, and the top-1 agreement."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                          device=dev)[None]
    with torch.no_grad():
        y, _ = tf.forward(params, tf.embed_inputs(params, seq), cfg)
        lg = ly.logits_fn(params, y[:, len(prompt) - 1:], cfg)[
            0, :, :cfg.vocab_size]
    got = lg.gather(1, torch.as_tensor(toks, device=dev).long()[:, None])[
        :, 0]
    short = (lg.max(-1).values - got).max().item()
    tol = 0.03 * lg.abs().max().item()
    exact = int((lg.argmax(-1).cpu().numpy() == toks).sum())
    return short, tol, exact



def phase_serve(cfg, params, dev, logit_gap):
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import make_request_stream, stream_requests
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
        short, tol, n_top1 = greedy_shortfall(params, cfg, dev,
                                              byrid[c.rid].tokens, c.tokens)
        if short > tol:
            fail(f"serve: rid {c.rid} served a token {short} below the "
                 f"recompute's top-1 (tol {tol})")
        worst = max(worst, short / tol)
        exact += n_top1
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


# prompt lengths of the 8k stream: one under the window (its fold_base
# stays 0 in a mixed batch), six greedy past it, one sampled
LONG_PROMPTS = (512, 2048, 2560, 3072, 3584, 4096, 4608, 6144)
LONG_NEW = 64
LONG_BLOCKS = 704           # < half the stream's 1696 blocks of rows


def phase_long_serve(cfg, params, dev):
    from repro_torch.kernels.kv_sketch import tail_fold, tail_scores
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.serve import stream_requests
    from repro_torch.serve.frontend import AsyncServeEngine
    from repro_torch.serve.scheduler import Request
    serve = dataclasses.replace(
        cfg.serve, max_batch=8, max_seq=LONG["max_seq"], kv_block_size=16,
        prefill_bucket=256, decode_chunk=8, prefix_block=16,
        num_kv_blocks=LONG_BLOCKS, kv_sketch_window=LONG["window"],
        kv_sketch_ratio=LONG["ratio"], kv_sketch_rows=LONG["rows"])
    rng = np.random.RandomState(SEED + 5)
    reqs = []
    for i, n in enumerate(LONG_PROMPTS):
        sampled = i == len(LONG_PROMPTS) - 1
        reqs.append(Request(
            rid=i, tokens=rng.randint(0, cfg.vocab_size, n).astype(np.int32),
            max_new=LONG_NEW, temperature=0.8 if sampled else 0.0,
            top_k=8 if sampled else 0, seed=SEED + 6 if sampled else None))
    front = AsyncServeEngine(cfg, params, serve=serve, device=dev)
    sched = front.scheduler
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tail_fold.launches = tail_scores.launches = 0   # the main path alone
    paged_attention.launches = 0
    t0 = time.perf_counter()
    done, ttfts = asyncio.run(stream_requests(
        front, reqs, 0.0, 0.0, np.random.RandomState(SEED + 7)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tail_fold=tail_fold.launches,
                    tail_scores=tail_scores.launches,
                    paged_attention=paged_attention.launches)
    st = sched.stats()
    leaked = sched.alloc.reserved - sched.prefix_cache.held_blocks()
    while sched.prefix_cache.evict_one():
        pass
    leaked += sched.alloc.reserved
    ntok = sum(len(c.tokens) for c in done)
    ok = [c for c in done if c.status == "ok" and len(c.tokens) == LONG_NEW
          and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
    rows = sum(LONG_PROMPTS) + LONG_NEW * len(LONG_PROMPTS)
    row_bytes = sched.alloc.block_bytes // sched.block_size
    dense_stream = rows * row_bytes
    if len(ok) != len(reqs) or leaked != 0 or st.fold_rows <= 0 \
            or st.kv_peak_reserved_bytes >= dense_stream \
            or min(launches.values()) <= 0:
        fail(f"long serve: completed ok {len(ok)}/{len(reqs)}, leaked "
             f"blocks {leaked}, fold rows {st.fold_rows}, peak reserved "
             f"{st.kv_peak_reserved_bytes} vs dense {dense_stream}, "
             f"launches {launches}")
    byrid = {c.rid: c for c in done}
    # the first request never folds: every served token must be the
    # exact recompute's top-1 within phase 3's tolerance
    short, tol, exact0 = greedy_shortfall(params, cfg, dev, reqs[0].tokens,
                                          byrid[0].tokens)
    if short > tol:
        fail(f"long serve: the unfolded request served a token {short} "
             f"below the recompute's top-1 (tol {tol})")
    # fidelity of a folded request against exact attention (reported)
    short1, tol1, exact1 = greedy_shortfall(params, cfg, dev,
                                            reqs[1].tokens, byrid[1].tokens)
    mean_chunk = float(np.mean(sched.chunk_ms))
    print(f"[long] gemma-2b full width, max_seq {LONG['max_seq']}, sketched "
          f"KV window {LONG['window']} ratio {LONG['ratio']} rows "
          f"{LONG['rows']} (C={sched.tail_cols}, T={sched.tail_domain}): "
          f"{len(reqs)} requests, prompts {list(LONG_PROMPTS)} (the last "
          f"sampled), {LONG_NEW} new each: {ntok} tokens in {wall:.4f}s = "
          f"{ntok / wall:.2f} tok/s, TTFT p50 "
          f"{np.percentile(ttfts, 50) * 1e3:.2f} ms, mean decode chunk "
          f"{mean_chunk:.3f} ms ({len(sched.chunk_ms)} chunks of "
          f"{serve.decode_chunk} steps)")
    print(f"[long] fold rows {st.fold_rows}; tail bytes "
          f"{st.kv_sketch_tail_bytes}; exact-window bytes (every pool block "
          f"is a slot's exact window: no prompt is cached) peak reserved "
          f"{st.kv_peak_reserved_bytes} ({st.blocks_peak} of {LONG_BLOCKS} "
          f"blocks); dense-equivalent bytes: the stream's {rows} rows "
          f"{dense_stream}, the engine's max_batch x max_seq "
          f"{st.kv_dense_equiv_bytes}; peak allocated "
          f"{torch.cuda.max_memory_allocated()} B; leaked blocks 0; "
          f"launches {launches}; greedy vs exact teacher-forced recompute: "
          f"unfolded {LONG_PROMPTS[0]}-token request {exact0}/{LONG_NEW} "
          f"top-1 (worst shortfall {short / tol:.2f} of tol), folded "
          f"{LONG_PROMPTS[1]}-token request {exact1}/{LONG_NEW} top-1 (worst "
          f"shortfall {short1 / tol1:.2f} of tol); {card()}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: train
# ---------------------------------------------------------------------------


class TrainProbe:
    """``train(on_grads=...)`` hook.  In-situ check: at step 0 it copies
    the stacked ``blocks/norm1`` leaf's gradient, params and pre-step
    tables; at step 1, before that step's update, it holds the tables and
    params the kernel path produced against the plain version run on the
    copies, and the params bitwise against the plain path's from the
    tables the kernel made.  Breakdown: from the hook of step 2 to the hook
    of step 3 (one step's work: step 2's optimizer, then step 3's batch,
    forward and backward) it runs the profiler and sums device time by
    kernel, the sketch_update kernels by name.  ``bound`` is the
    optimizer's least time a step for its sketched leaves: g, the tables
    read and written, and the params read and written (the fused form) or
    the estimates written (the estimates form), each once."""

    def __init__(self):
        self.saved = None
        self.report = None
        self.moment_bytes = None
        self.prof = None
        self.breakdown = None
        self.bound = None
        self.sketch_ms = None
        self.mem = []           # (allocated, peak so far) at each hook

    def __call__(self, step, params, grads, opt):
        from torch.profiler import ProfilerActivity, profile
        self.mem.append((torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
        if step == 2:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == 3:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            events = sorted(
                (e for e in self.prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
            self.prof = None
            by_name = {}
            for e in events:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
            busy = sum(by_name.values())
            if busy <= 0:
                fail("the profiler recorded no device time in the train "
                     "step")
            split = sketch_split(by_name)
            sk = sum(split.values())
            gemm = sum(v for k, v in by_name.items()
                       if any(f in k.lower() for f in (
                           "gemm", "xmma", "cutlass", "nvjet")))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            # the optimizer's span: from the window's start (step 2's
            # update follows the hook) to the end of the last
            # sketch_update kernel; what else runs in it is the dense
            # leaves' and (per-piece form) the elementwise AdamW math and
            # the coefficient casts
            last = max((i for i, e in enumerate(events)
                        if sketch_kernel(e.name)), default=-1)
            span = events[:last + 1]
            opt_ms = sum(e.time_range.elapsed_us() for e in span) / 1e3
            self.sketch_ms = sk
            self.breakdown = (
                f"one step under the profiler (step 2's optimizer + step "
                f"3's forward/backward): wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle); "
                f"sketch_update kernels {sk:.3f} ms "
                f"({100 * sk / busy:.1f}% of busy: "
                + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"), GEMMs {gemm:.3f} ms "
                f"({100 * gemm / busy:.1f}%), other {busy - sk - gemm:.3f} "
                f"ms; the optimizer's span {opt_ms:.3f} ms on the device "
                f"({len(span)} kernels), of which not sketch_update "
                f"{opt_ms - sk:.3f} ms; top kernels "
                + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
        from repro_torch.kernels import ref
        from repro_torch.models.transformer import param_leaves
        from repro_torch.sketch.optimizer import moment_state_bytes
        from repro_torch.train.optimizer import bias_corrections
        names = [n for n, _ in param_leaves(params)]
        i = names.index("blocks/norm1")
        mo = opt.moments[i]
        if step == 0:
            self.moment_bytes = moment_state_bytes(opt)
            fused = est = 0
            for (_, ps), (_, gs), m in zip(param_leaves(params),
                                           param_leaves(grads), opt.moments):
                if not hasattr(m.m, "table"):
                    continue
                n = sum(p.numel() for p in ps)
                common = (sum(g.numel() * g.element_size() for g in gs)
                          + 2 * 2 * m.m.table.numel() * 4)
                fused += common + 2 * sum(p.numel() * p.element_size()
                                          for p in ps)
                est += common + 2 * n * 4
            self.bound = (fused / HBM_BYTES_PER_S * 1e3,
                          est / HBM_BYTES_PER_S * 1e3)
            self.saved = dict(
                g=[t.clone() for t in param_leaves(grads)[i][1]],
                p=[t.clone() for t in param_leaves(params)[i][1]],
                m=mo.m.table.clone(), v=mo.v.table.clone())
            return
        if step != 1:
            return
        sv = self.saved
        off = [k * sv["g"][0].numel() for k in range(len(sv["g"]))]
        pieces = list(zip([t.reshape(-1) for t in sv["g"]], off))
        new_m, new_v = ref.sketch_accumulate_ref(
            pieces, sv["m"], sv["v"], mo.m.coeffs, mo.v.coeffs, B1, B2)
        bc1, bc2 = bias_corrections(B1, B2, 1)
        # from the tables the kernel made, the plain path's params bitwise
        # (before the loop below updates the saved params in place)
        same = []
        for p, now, (g, o) in zip(sv["p"], param_leaves(params)[i][1],
                                  pieces):
            mh, vh = ref.sketch_retrieve_ref(g.numel(), o, mo.m.table,
                                             mo.v.table, mo.m.coeffs,
                                             mo.v.coeffs)
            q = p.clone()
            ref.sketched_leaf_update(q, mh, vh, lr=TRAIN["lr"], eps=1e-8,
                                     weight_decay=0.01, bc1=bc1, bc2=bc2)
            same.append(torch.equal(q, now))
        if not all(same):
            fail(f"in-situ norm1 params: {same.count(False)} pieces differ "
                 f"from the plain path's given the kernel's tables")
        want_p = []
        for p, (g, o) in zip(sv["p"], pieces):
            mh, vh = ref.sketch_retrieve_ref(g.numel(), o, new_m, new_v,
                                             mo.m.coeffs, mo.v.coeffs)
            ref.sketched_leaf_update(p, mh, vh, lr=TRAIN["lr"], eps=1e-8,
                                     weight_decay=0.01, bc1=bc1, bc2=bc2)
            want_p.append(p)
        err_t = max(close_to(mo.m.table, new_m, "in-situ norm1 m table"),
                    close_to(mo.v.table, new_v, "in-situ norm1 v table"))
        got = torch.stack([t.float() for t in param_leaves(params)[i][1]])
        want = torch.stack([t.float() for t in want_p])
        err_p = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=2 ** -7,
                              atol=2 ** -9 * want.abs().max().item()):
            fail(f"in-situ norm1 params: max err {err_p} (one bf16 ulp "
                 f"allowed)")
        self.report = (f"in-situ step-1 norm1 ({len(pieces)} pieces of "
                       f"{sv['g'][0].numel()}, tables {tuple(new_m.shape)})"
                       f" kernel vs plain: tables max|err| {err_t:.3e}, "
                       f"params max|err| {err_p:.3e} (one bf16 ulp allowed);"
                       f" from the kernel's tables the params bitwise the "
                       f"plain path's")
        self.saved = None


# batch and seq are launch/train.py's defaults; lr is train()'s default:
# the CLI's 3e-3, tuned on the reduced configs, took the full-width
# model's loss from 11.6 to 129 in one step on the card
TRAIN = dict(steps=4, batch=8, seq=128, lr=3e-4)


def phase_train(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.train.loop import train
    cfg = get_config("yi-9b")
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, opt_state_ratio=4, opt_state_rows=3,
        opt_state_min_elems=1 << 16))
    logs = []
    probe = TrainProbe()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    sketch_update.launches = 0              # count the main path alone
    paged_attention.launches = 0
    t0 = time.perf_counter()
    hist = train(cfg, **TRAIN, seed=SEED, device=dev, log_every=1,
                 log_fn=logs.append, on_grads=probe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sketch_update.launches
    peak = torch.cuda.max_memory_allocated()
    for ln in logs:
        print(f"[train] {ln}")
    b = probe.moment_bytes
    n_params = cfg.param_count()
    if not all(np.isfinite(hist.losses)) or len(hist.losses) != 4 \
            or launches <= 0 or probe.report is None \
            or probe.breakdown is None:
        fail(f"train: losses {hist.losses}, sketch_update launches "
             f"{launches}, in-situ check {probe.report}")
    print(f"[train] yi-9b full width and depth ({cfg.num_layers} layers, "
          f"{n_params} params), batch {TRAIN['batch']} x seq "
          f"{TRAIN['seq']}, sketched AdamW ratio 4 rows 3: losses "
          + ", ".join(f"{x:.4f}" for x in hist.losses) + "; step ms (the "
          "profiler runs from step 2's optimizer to step 3's backward) "
          + ", ".join(f"{t * 1e3:.1f}" for t in hist.step_times)
          + f"; {wall:.2f}s for the run incl. init; [opt] sketched moments "
          f"{b['sketched']} B + {b['dense']} B dense leaves vs dense AdamW "
          f"{8 * n_params} B; {start} B allocated at the start; peak "
          f"allocated {peak} B ({peak / 2 ** 30:.2f} GiB; at the hook of "
          f"step k, allocated / peak so far: "
          + ", ".join(f"{a} / {p}" for a, p in probe.mem)
          + f") of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory} B; "
          f"sketch_update launches {launches} "
          f"({launches // TRAIN['steps']} per step), paged_attention "
          f"launches {paged_attention.launches}; {card()}")
    print(f"[train] {probe.report}")
    print(f"[train] {probe.breakdown}")
    print(f"[train] sketch_update per step: {probe.sketch_ms:.3f} ms on the "
          f"device in the profiled step, {launches // TRAIN['steps']} "
          f"launches; bound {probe.bound[0]:.3f} ms (fused form; "
          f"{probe.bound[1]:.3f} ms with the estimates written); {card()}")
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
    def held(after):
        before = torch.cuda.memory_allocated()
        gc.collect()
        print(f"[mem] after {after}: {before} B allocated, "
              f"{torch.cuda.memory_allocated()} B after gc.collect()")

    rows = phase_kernel(flush)
    sk_rows = phase_sketch_kernel(flush)
    fold_rows, score_rows = phase_kv_kernels(flush)
    cs_rows, un_rows = phase_cs_kernels(flush)
    held("the kernel phases (the 256 MB flush buffer held)")
    cpd_launches = phase_cpd(dev)
    held("cpd")

    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=SEED, device=dev)
    gap = phase_model(cfg, params, dev, flush)
    phase_sketch_model(cfg, params, dev, flush)
    del flush
    launches = phase_serve(cfg, params, dev, gap)
    long_launches = phase_long_serve(cfg, params, dev)
    del params                               # free gemma-2b for training
    torch.cuda.empty_cache()
    held("serve and long, gemma-2b freed")
    sk_launches = phase_train(dev)

    d = rows["decode"]
    sk = sk_rows[SKETCH_MAIN]
    record = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:89",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"]}, {
        "name": "sketch_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_update.cu",
        "replaces": "src/repro/kernels/sketch_update.py:125",
        "launches": sk_launches,
        "max_abs_err": max(r["max_abs_err"] for r in sk_rows.values()),
        "ms": sk["kernel_ms"], "plain_ms": sk["plain_ms"],
        "bound_ms": sk["bound_ms"], "bound_by": sk["bound_by"],
        "library_ms": None,
        # ms, plain_ms and bound_ms are the estimates form's (the plain
        # version's contract); the train path runs the fused form
        "apply_ms": sk["apply_ms"], "apply_bound_ms": sk["apply_bound_ms"]}]}
    for name, main, geo, replaces in (
            ("tail_fold", "decode_fold", fold_rows,
             "src/repro/kernels/kv_sketch.py:90"),
            ("tail_scores", "decode_scores", score_rows,
             "src/repro/kernels/kv_sketch.py:129")):
        r = geo[main]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kv_sketch.cu",
            "replaces": replaces, "launches": long_launches[name],
            "max_abs_err": max(g["max_abs_err"] for g in geo.values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for name, main, geo, replaces in (
            ("count_sketch", CS_MAIN, cs_rows,
             "src/repro/kernels/count_sketch.py:43"),
            ("unsketch", UNSKETCH_MAIN, un_rows,
             "src/repro/kernels/unsketch.py:35")):
        r = geo[main]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/count_sketch.cu",
            "replaces": replaces, "launches": cpd_launches[name],
            "max_abs_err": max(g["max_abs_err"] for g in geo.values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
