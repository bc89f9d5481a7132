"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
the sources in this checkout, holds each against its plain version, runs
the paper's sketched CP decompositions and codecs at the paper's sizes,
checks the full-width model against its plain path, serves full-width
gemma-2b (at 512, speculatively, and, sketched, at 8k context, plainly
and speculatively; the 512-token speculative and the 8k plain streams at
cut depth), trains full-width yi-9b
(also with FCS gradient compression), serves the moe family and the
other attention configs (granite-moe, deepseek-moe and four more, at
full width and cut depth), plainly and (granite-moe, deepseek-moe,
qwen2.5, at cut depth) speculatively, and the recurrent families
(xlstm-1.3b and zamba2-2.7b at full width and cut depth), and trains
every family (moe, audio, vlm, ssm, hybrid) through the port's main
paths, and runs the launch tooling at a mesh of one.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. build     — nvcc for sm_90a, one process per source, all at once
  2. kernel    — paged attention vs its plain version at the decode and
                 chunked-prefill geometries at max_seq 512 and 8192 (and
                 at 512 for each (K, R, hd) of phase moe's six configs),
                 a reduced (hd=16) one and the verify step at spec_k 4, 7
                 and 8 and at phase moe-spec's shapes (each verify row
                 also bitwise the Sq = 1 call at its position), with its
                 split plan (blocks,
                 splits), two launches held bitwise equal, kernel / plain
                 / library (SDPA yardstick) times and the bandwidth
                 bound; sketch_update vs its plain version at
                 the reference's four kernel shapes, one yi-9b w_gate
                 layer piece whose indices pass 2^31 and the whole
                 48-piece w_gate leaf in one call: the estimates form's
                 tables and estimates, a second accumulate's tables
                 bitwise the first's, at the reference's shapes the
                 tables bitwise the ordered model
                 (sketch_accumulate_ordered_ref), the fused form's
                 tables bitwise the estimates form's, and its params
                 bitwise the plain path's from the same tables, with
                 both forms' times by kernel, the plain time and the
                 bounds
     kv        — tail_fold and tail_scores vs their plain versions at the
                 8k serve shapes (decode-chunk fold, prefill fold-through,
                 decode and chunked-prefill scores) and reduced shapes
                 with 2 and 4 hash rows, with kernel / plain / library
                 (index_add_ for the fold) times and the bound; the fold
                 also held bitwise to a row-by-row fold and to a second
                 launch, with its grid; the sharded serve path's forms
                 at phase launch's shapes: the column-range fold and the
                 products pass on a 256-column shard, each bitwise the
                 unsharded kernel's columns and timed against its plain
                 version
     cs        — count_sketch and unsketch vs their plain versions at the
                 reference's six shapes, a bf16 case and the cpd path's
                 shapes (the CS oracle's 100 x 1,000,000 sketch and its
                 1 x 1,000,000 sketch of vec(T), Fig. 5's 2,400,000-entry
                 decompress, the FCS tiuu), a J past the shared-memory
                 accumulators and the speculative path's (the compressed
                 draft's weight sketches and reconstructions at gemma-2b's
                 leaf shapes, the sketched head's activation sketch, the
                 one-chunk sketch of the tail span's softmax weights; the
                 moe and qwen2.5 drafts' shapes, ``draft_sketch_shapes``),
                 with the branch each took, kernel / plain
                 / library (index_add_, index_select) times, the bound
                 and the bucket-link build time; count_sketch also held
                 bitwise to its tiled model and to a second launch
     cpd       — the paper core and CPD at the paper's sizes: Fig. 1 RTPM
                 (I 100, rank 10, D 2; plain held against the same run
                 on the CPU; TS and FCS at J 1000 / 4000 / 10000 with
                 every oracle call of a card run from 5 of the 15 inits
                 (SHADOW_INITS) repeated on the CPU; CS
                 on vec(T) at J 10000 with three oracle calls held against
                 the plain version on the card), Table 2 (HCS vs FCS at
                 I 50, oracle calls repeated on the CPU), ALS (I 80, D 10,
                 30 sweeps; every MTTKRP call repeated on the CPU, plain
                 also as a whole run; TS and FCS at J 1000 (Fig. 1) and
                 1500 (ALS) held bitwise to a second run of their own,
                 CPD_REPEAT) and the Fig. 5 / 6 codecs at cr 2-16
                 (decompress kernel vs plain, error falling with cr); both
                 kernels launched, counted over the path's runs alone,
                 with their device time inside each run
  3. model     — full-width gemma-2b decode_step logits, kernel vs plain;
                 then sketched: a populated tail on most slots, kernel vs
                 plain, and slots that folded nothing equal to the
                 sketch-free step bitwise
  4. serve     — 16 requests through the async engine (the path
                 ServeEngine.generate wraps), launches counted, greedy
                 output checked against a teacher-forced recompute.
                 Every serve phase (serve, spec, long, long-spec) runs
                 its engines with the decode and prefill chunks replayed
                 as CUDA graphs (the card's default) and again as their
                 eager twins (graphs=False), each stream twice (timed,
                 then profiled) and a profiled decode window: the graphed
                 engine must equal its twin bitwise (tokens, completion
                 order, emit flags, allocator books, pool rows after the
                 window's prefill and at the end, tail tables, launch
                 counts, callers' generator states) and capture each
                 variant once (prefill: 1 on a sketch-free engine, at
                 most 2 on a sketched one); a [graphs] line gives both
                 engines' decode chunk ms, prefill chunk ms, busy per
                 step, idle shares, tok/s and TTFT, the captures and both
                 graph pools' bytes.  Phases serve and long also run a
                 third engine, graphed, with a full observer
                 (repro_torch.obs: every request traced, a metrics window
                 a round, on long the fidelity probe every round; the
                 eager twin carries one too): it must equal the
                 unobserved graphed engine bitwise with the same
                 captures, its observer's counters and histogram samples
                 must equal the eager twin's and agree with its
                 EngineStats, its trace must parse with every span
                 closed; an [obs] line splits its first pass's wall into
                 the pump's dispatch and collect spans, the prefill
                 chunks' host launch spans and the rest
     spec      — full-width verify_step at spec_k 4 and 8 bitwise 5 and
                 9 decode steps (at 8 its 72 rows run in two slabs of the
                 engine's 64) and a verify step's device ms at spec_k 7
                 and 8; then, at full width cut to SPEC_LAYERS of the 18
                 layers, the serve stream (and two whole-prompt
                 prefix hits) through a plain engine and four spec
                 engines (truncated draft of depth 1; that draft
                 count-sketch-compressed at ratio 4 with the sketched
                 head; per-request spec_k 0 / 4; spec_k 8), each with its
                 eager twin as above: greedy tokens
                 bitwise the plain engine's, no leaks, copy-on-write
                 forks, acceptance reported, the paged-attention,
                 count_sketch and unsketch kernels launched
     long      — gemma-2b at full width cut to LONG_LAYERS of its 18
                 layers, at max_seq 8192 with sketched KV (window 1024,
                 ratio 8, rows 3): 8 requests of 512 to 6144 prompt
                 tokens and 64 new each through a pool of half their
                 rows; every request completes, no block leaks, rows
                 fold, and the tail kernels and the count sketch of the
                 tail span's weights are launched on the path
     long-spec — two of those prompts (2048, 4096 tokens), at all 18
                 layers, through a
                 sketched plain engine and a sketched spec engine
                 (spec_k 2): tokens bitwise equal (the draft's proposals
                 are not accepted here; see LONG_LAYERS), both pools
                 fold, both tail kernels launched on the spec path
  5. train     — yi-9b at full width and depth, 4 steps of batch 8 x 128
                 tokens with sketched AdamW (ratio 4, rows 3) through
                 train/loop.py; losses finite, sketch_update launched,
                 step 1's norm1 tables and params checked in situ against
                 the plain version from the step's own gradient (the
                 tables bitwise the ordered model, the params bitwise
                 from the kernel's tables); one profiled
                 step split by kernel, sketch_update's per step against
                 its bound.  Then 2 steps with FCS gradient compression
                 (ratio 16) before the optimizer: losses finite, as many
                 leaves compressed each step as the codecs name, one
                 leaf's estimate bitwise unsketch_leaf of the main path's
                 sketch and that sketch bitwise sketch_leaf of the raw
                 gradient; the compression's ms a step, its bound, the
                 sketch bytes a step, peak memory.
                 Between the two, on the same model and optimizer state
                 after the four steps, the reference's train_4k context
                 (TRAIN_4K): 2 steps of batch B x 4096 tokens, B 4 if
                 the dry run's walk of that step at a mesh of one plus
                 the moment state is at most 72 GB, else 2; losses
                 finite, peak below the card's memory, sketch_update
                 launched, and one layer's KV-chunked causal_attention at
                 (B, 4096) (output and gradients for a seeded cotangent)
                 within ATTN_GATE of a dense f32 S x S version on the
                 card; a [train-4k] line (step ms, tokens/s, forward /
                 backward / sketch_update device ms, peak allocated and
                 the walk's estimate).  Last, the resume checks
                 (``resume_check``, RESUME): yi-9b at full width, 4 of 48
                 layers, sketched AdamW, 4 steps straight, then a run
                 checkpointed at step 2 through train/checkpoint.py,
                 crashed at 3 and resumed: losses, params, every moment
                 table and the step counter bitwise the straight run's;
                 the same with FCS compression (ratio 16)
  6. moe       — after yi-9b is freed: granite-moe-3b-a800m at full width
                 cut to 4 of its 32 layers (MOE_LAYERS; the serve phase's
                 16-request stream; no drop
                 is possible, so its greedy tokens are held to a
                 teacher-forced recompute of a dropless copy, forced onto
                 the experts the served rows chose, which the eager twin
                 records), deepseek-moe-16b at full width cut to 4 of 28
                 layers (8 requests) and minitron-4b, qwen2.5-32b,
                 musicgen-medium
                 and internvl2-2b at full width cut to 2 layers (4 each),
                 every engine graphed and as its eager twin, bitwise; a
                 decode step's and a chunk's logits, kernel path vs plain
                 path on the kernel path's routing, within 3% of max|logit|,
                 every routing decision the plain path would change
                 within NEAR_TIE of a tie; a [profile] and a [moe]
                 line per config (tok/s, TTFT, chunk ms, captures, the FFN
                 weight bytes a decode step reads); its paged-attention
                 launches are all at shapes phase 2 holds
     moe-spec  — granite-moe at full width, MOE_SPEC_GRANITE_LAYERS of its
                 32 layers, through a plain
                 engine and truncated and ratio-4 drafts at spec_k 4 (40
                 verify rows within C 40: greedy tokens bitwise plain),
                 then an exact draft (the whole target at MOE_SPEC_LAYERS
                 layers, spec_k 2; acceptance > 0); deepseek-moe at
                 MOE_SPEC_LAYERS of 28 layers, plain and a ratio-4 draft
                 (C 20: bitwise up to each request's first dropped choice,
                 drops counted from the eager twins' routing); qwen2.5 at
                 CUT_LAYERS with random attention biases (bitwise plain;
                 the drafts' biases the target's); every spec engine
                 graphed and as its eager twin, bitwise, its speculative
                 counters the twin's (the plain engines, whose twins
                 phase moe holds, run once); [spec], [profile] and
                 [moe-spec] lines
  7. recurrent — after the moe models are freed: xlstm-1.3b and
                 zamba2-2.7b at full width, cut in depth (REC_LAYERS:
                 xlstm one layer group, 8 of 48 layers, both block
                 kinds; zamba2 two groups, 12 of 54, both shared
                 blocks), each
                 config's own
                 serve geometry (max_batch 8, max_seq 512, decode_chunk
                 8), 16 requests at once (prompts of 1-448 tokens, 1-4
                 among them, 32 new each, a quarter sampled), each engine
                 graphed and as its eager twin, both passes and a decode
                 window bitwise (tokens, order, emit flags, every slot
                 state leaf after the window's admissions and at the end,
                 callers' generator states); one decode capture per
                 variant used, none on the second pass, no prefill
                 capture; every request completes; every greedy token
                 within REC_TOL of the top-1 of a full-sequence recompute
                 by the port's own forward; decode_step after a prefill
                 of S tokens within REC_TOL of the (S + 1)-token forward;
                 none of the six kernels launched; a [recurrent] and a
                 [profile] line per config (tok/s, TTFT, decode chunk ms,
                 prefill ms, busy per step, idle shares, state bytes, a
                 decode step's top kernels)
  8. train-families — after the recurrent models are freed: 3 steps of
                 batch 8 x 128 through train/loop.py with sketched AdamW
                 (ratio 4, rows 3) for granite-moe-3b-a800m (full width,
                 8 of 32 layers), deepseek-moe-16b (full width, 4
                 layers), musicgen-medium and internvl2-2b (full width,
                 24 of 48 and 12 of 24 layers, the frontend stubs'
                 embeds batches), xlstm-1.3b (full width, 16 of 48
                 layers, two layer groups) and zamba2-2.7b (full width,
                 18 of 54 layers, three groups); losses
                 finite,
                 sketch_update launched, one sketched leaf that only the
                 family has checked in situ as phase 5 checks norm1;
                 granite, xlstm and zamba2 also an f32 copy's backward
                 against central differences along a seeded random
                 direction (``directional_check``; granite on the
                 routing of the point, the unforced routing flips
                 reported); a [train-families] line per config (step ms,
                 tokens/s, forward / backward / sketch_update device ms,
                 moment and peak bytes); granite-moe's resume check at
                 4 layers, as phase 5's
  9. launch    — the launch tooling at a mesh of one: a world-1 NCCL
                 group through a FileStore, a (1, 1) mesh; yi-9b (full
                 width, 4 of 48 layers, batch 8 x 128) through
                 make_train_step at FSDP placements, loss and gradients
                 bitwise the unsharded step's, sketched AdamW after it
                 (sketch_update launched; tables and params bitwise the
                 unsharded run's); make_podwise_compressed_step over
                 a pod of one (estimates bitwise unsketch_leaf of the
                 pod-mean sketch, sketches bitwise the plain compressed
                 step's, sketch bytes = sum J~ x 4); gemma-2b
                 (full width, 2 layers) through make_serve_step at the
                 decode TP placements, logits and pool rows bitwise
                 (paged_attention launched); the dry run's argument
                 bytes equal to the card's and its peak within 0.67-1.5
                 of max_memory_allocated, and three production cells'
                 peaks and roofline terms, from a CPU process started
                 with the script (``start_dryrun``); and 4 emulated FSDP
                 ranks on a yi-9b w_gate leaf (4 layers): each rank's
                 strided block through the kernel's accumulate into zero
                 tables, the partials summed in rank order within 1e-5
                 of max|table| of the unsharded accumulate, each rank's
                 strided apply from the folded tables within lr x D + 1
                 ulp of the unsharded apply, a second run of the ranks
                 bitwise the first, one rank's pieces timed;
                 4 emulated kv_blocks ranks (models/ranks.py:run_ranks)
                 of one full-width gemma-2b layer at the 8k sketched
                 geometry, the pool split by blocks and the tails by
                 256-column shards: the decode chunk's fold bitwise the
                 unsharded fold's columns, one decode step's select
                 estimates bitwise the unsharded tail_scores kernel's,
                 its output within 1e-4 x max + 2^-8 x max|v| (bf16 p at
                 each rank's running max); 4 emulated EP ranks of one
                 full-width deepseek-moe layer (16 experts each),
                 forward and backward at 8 x 128 tokens against the
                 gathered form
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

# H100 SXM device memory bytes/s and dense bf16 FLOP/s: the datasheet
# peaks of src/repro_torch/launch/cost_analysis.py, set by load_rates()
HBM_BYTES_PER_S = BF16_FLOPS = None
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor rate
SEED = 0


def load_rates() -> None:
    global HBM_BYTES_PER_S, BF16_FLOPS
    from repro_torch.launch.cost_analysis import HBM_BW, PEAK_FLOPS_BF16
    HBM_BYTES_PER_S, BF16_FLOPS = HBM_BW, PEAK_FLOPS_BF16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def kernel_records(prof):
    """The device kernels a finished profiler session recorded, in start
    order: (name, start ns, duration ns) each, read from the raw CUPTI
    records.  Building the profiler's event tree instead costs tens of
    microseconds of host time per record (a plain paged-attention call
    launches thousands of kernels, an eager sLSTM step tens of
    thousands)."""
    out = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    out.sort(key=lambda r: r[1])
    return out


def device_ms(fn, n: int, flush: torch.Tensor):
    """Device time of ``fn`` per call: the sum of the durations of the
    kernels it launches, from the profiler's CUPTI records (kernels only:
    no host op is recorded), with the L2 flushed before each call (the
    decode path reaches each layer's pool after other layers' weights
    have passed through the cache).  The flush's own kernel is left out
    by name.  Returns (ms per call, {kernel name: ms per call}, host wall
    ms per call).  A window in which the profiler delivered no kernel
    record at all is profiled again, up to ``WINDOWS`` windows, and a
    ``[profiler]`` line says so; that many empty windows fail."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for window in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        by_name = {}
        for name, _, ns in kernel_records(prof):
            if "bitwise_not" in name:
                continue
            by_name[name] = by_name.get(name, 0.0) + ns / 1e6 / n
        total = sum(by_name.values())
        if total > 0:
            if window:
                print(f"[profiler] {window} window(s) recorded no kernel; "
                      f"{total:.5f} ms from the next "
                      f"({', '.join(sorted(by_name))})")
            return total, by_name, wall
    fail(f"the profiler recorded no device time in {WINDOWS} windows")


# profiled windows device_ms tries before it fails: an H100 has twice
# delivered no record of a 2-microsecond kernel in a window, and once in
# two windows in a row (phase cs, ``unsketch`` at (1, 50, 300))
WINDOWS = 4


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

# name: (B, Sq, K, R, hd, NB, bs, nb)
# decode and chunk prefill of the 512-token serve (nb 32) and of the 8k
# sketched serve (nb 512, starts drawn up to 8191), a reduced one, and the
# speculative verify step of the 512-token serve at spec_k 4, 7 and 8 and of
# the 8k sketched spec run at spec_k 2 (Sq = spec_k + 1; each verify row
# is also held bitwise to the Sq = 1 call at its position)
GEOMETRIES = {
    "decode": (8, 1, 1, 8, 256, 256, 16, 32),
    "chunk_prefill": (1, 32, 1, 8, 256, 256, 16, 32),
    "reduced_hd16": (4, 1, 1, 4, 16, 24, 16, 6),
    "decode_8k": (8, 1, 1, 8, 256, 4096, 16, 512),
    "chunk_prefill_8k": (1, 256, 1, 8, 256, 4096, 16, 512),
    "verify_k4": (8, 5, 1, 8, 256, 256, 16, 32),
    "verify_k7": (8, 8, 1, 8, 256, 256, 16, 32),
    "verify_k8": (8, 9, 1, 8, 256, 256, 16, 32),
    "verify_k2_8k": (8, 3, 1, 8, 256, 4096, 16, 512),
}
# phase moe's engines (max_seq 512, blocks of 16): the decode and the
# 32-token chunk prefill of each config's (K, R, hd) — granite-moe (8, 3,
# 64), deepseek-moe (16, 1, 128), minitron (8, 3, 128), qwen2.5 (8, 5,
# 128), musicgen (24, 1, 64), internvl2 (8, 2, 128)
MOE_HEADS = {"granite": (8, 3, 64), "deepseek": (16, 1, 128),
             "minitron": (8, 3, 128), "qwen": (8, 5, 128),
             "musicgen": (24, 1, 64), "internvl2": (8, 2, 128)}
for _name, (_K, _R, _hd) in MOE_HEADS.items():
    GEOMETRIES[f"decode_{_name}"] = (8, 1, _K, _R, _hd, 256, 16, 32)
    GEOMETRIES[f"chunk_prefill_{_name}"] = (1, 32, _K, _R, _hd, 256, 16, 32)
# phase moe-spec's verify steps: granite-moe, deepseek-moe and qwen2.5 at
# spec_k 4 (MOE_SPEC_K) and granite's exact-draft engine at spec_k 2
# (gemma-2b's at spec_k 8 is verify_k8)
for _name, _Sq in (("granite", 5), ("granite", 3), ("deepseek", 5),
                   ("qwen", 5)):
    GEOMETRIES[f"verify_k{_Sq - 1}_{_name}"] = (8, _Sq, *MOE_HEADS[_name],
                                                256, 16, 32)


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
        rows_note = ""
        if name.startswith("verify"):
            # each verify row is the decode call's at its position
            q, kp, vp, tables, start, fb = args
            for i in range(Sq):
                one = paged_attention(q[:, i:i + 1].contiguous(), kp, vp,
                                      tables, start + i, fb)
                if not (torch.equal(m[..., i], one[0][..., 0])
                        and torch.equal(l[..., i], one[1][..., 0])
                        and torch.equal(acc[..., i, :], one[2][..., 0, :])):
                    fail(f"paged_attention {name}: verify row {i} differs "
                         f"from the Sq = 1 call at start + {i}")
            rows_note = (f"; each of the {Sq} verify rows bitwise the Sq = 1 "
                         f"call at its position")
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
              f"bitwise equal{rows_note}; max|acc/l err| "
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
    """rtol 1e-5 and atol 1e-5 x max|want| (the kernel adds each cell's
    scaled terms one at a time in element order, the plain version sums in
    its own order and scales the sum; see csrc/sketch_update.cu).  Returns
    max |got - want|."""
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


# geometries whose accumulate is also held bitwise to the ordered model
# (kernels/ref.py:sketch_accumulate_ordered_ref): the reference's four
SKETCH_ORDERED = ("ref_1000", "ref_4096", "ref_700", "ref_8192")


def phase_sketch_kernel(flush):
    """sketch_update at each geometry: the estimates form (tables and
    every piece's estimates vs the plain version; a second launch's tables
    bitwise the first's; at ``SKETCH_ORDERED`` the tables bitwise the
    ordered model) and the fused form (tables bitwise the estimates
    form's; from the tables it made, params bitwise the plain path's),
    then both forms timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sketch_update import (accumulate, entry_bytes,
                                                   plan_groups, sketch_apply,
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
        # the accumulate's order is fixed: a second launch gives the same
        # bits, and so does the ordered model
        am, av = m0.clone(), v0.clone()
        accumulate(pieces, am, av, cm, cv, b1=B1, b2=B2)
        if not (torch.equal(am, km) and torch.equal(av, kv)):
            fail(f"sketch_update {name}: a second accumulate's tables "
                 f"differ from the first's")
        del am, av
        ordered = name in SKETCH_ORDERED
        if ordered:
            om, ov = ref.sketch_accumulate_ordered_ref(pieces, m0, v0, cm,
                                                       cv, B1, B2)
            if not (torch.equal(om, km) and torch.equal(ov, kv)):
                fail(f"sketch_update {name}: tables differ from the ordered "
                     f"model's, max |diff| "
                     f"{max(float((om - km).abs().max()), float((ov - kv).abs().max()))}")
            del om, ov
        for (g, o), (mh, vh) in zip(pieces, est):
            rmh, rvh = ref.sketch_retrieve_ref(n, o, rm, rv, cm, cv)
            err = max(err, close_to(mh, rmh, f"sketch_update {name} m_hat"),
                      close_to(vh, rvh, f"sketch_update {name} v_hat"))
            del mh, vh, rmh, rvh
        torch.cuda.empty_cache()
        # fused form: tables bitwise the estimates form's, params bitwise
        # the plain path's from the tables the kernel made
        gen = torch.Generator(dev).manual_seed(SEED + 40 + gi)
        params = [torch.randn(n, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(P)]
        start = [p.clone() for p in params]
        fm, fv = m0.clone(), v0.clone()
        sketch_apply(pieces, params, fm, fv, cm, cv, b1=B1, b2=B2, **ADAMW)
        if not (torch.equal(fm, km) and torch.equal(fv, kv)):
            fail(f"sketch_apply {name}: tables differ from the estimates "
                 f"form's")
        del rm, rv, km, kv
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
              f"and estimates); a second accumulate"
              + (" and the ordered model" if name in SKETCH_ORDERED else "")
              + f" bitwise; the fused form's tables bitwise the estimates "
              f"form's, its params bitwise the plain path's from "
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
# of 18 x k/v = 36 tables.  The 8k spec run at spec_k 2 (a chunk advances
# up to 8 x 3 = 24 rows, so fold_cap is 48) folds the target's 288
# tables and its depth-2 draft's 2 x 8 x k/v = 32, and the draft's
# prefill fold-through 2 x k/v = 4 tables.  Then reduced shapes with even
# and odd Z, the counts ragged.
FOLD_GEOMETRIES = {
    "decode_fold": (288, 32, 3, 1024, 256),
    "prefill_fold": (36, 272, 3, 1024, 256),
    "spec_decode_fold": (288, 48, 3, 1024, 256),
    "spec_draft_decode_fold": (32, 48, 3, 1024, 256),
    "spec_draft_prefill_fold": (4, 272, 3, 1024, 256),
    "reduced_z2": (12, 40, 2, 64, 32),
    "reduced_z4": (12, 40, 4, 64, 32),
    # phase long at LONG_LAYERS = 4: 4 x 8 x k/v and 4 x k/v tables
    "decode_fold_4_layers": (64, 32, 3, 1024, 256),
    "prefill_fold_4_layers": (8, 272, 3, 1024, 256),
}
# name: (B, K, N, hd, Z, C, T).  8k decode: 8 slots x 8 query heads of one
# kv head; chunked prefill: one slot's 256-token chunk x 8 heads; the 8k
# spec run's verify step at spec_k 2: 3 rows x 8 heads a slot.
SCORE_GEOMETRIES = {
    "decode_scores": (8, 1, 8, 256, 3, 1024, 8192),
    "chunk_scores": (1, 1, 2048, 256, 3, 1024, 8192),
    "verify_scores_k2": (8, 1, 24, 256, 3, 1024, 8192),
    "reduced_z2": (2, 2, 6, 32, 2, 64, 512),
    "reduced_z4": (2, 1, 5, 32, 4, 64, 512),
}


# The sharded serve path's forms, at phase launch's emulated ranks
# (``launch_emulated_kv``: gemma-2b's long geometry, one layer of 8 slots,
# the pool and the tails split 4 ways): the decode chunk's fold of 32 rows
# a table into a 256-column shard of C 1024, (G, N, Z, C, D, c0, Cl); the
# decode step's bucket products on that shard, (B, K, N, hd, Z, C, c0, Cl)
FOLD_RANGE_GEOMETRY = (16, 32, 3, 1024, 256, 256, 256)
PRODUCTS_GEOMETRY = (8, 1, 8, 256, 3, 1024, 256, 256)


def phase_kv_forms(flush):
    """The column-range ``tail_fold`` and the products pass on a column
    shard (``tail_products``) against their plain versions at the
    emulated ranks' shapes: the range fold bitwise the unsharded kernel's
    columns and within 1e-5 x max|table| of the plain range fold; the
    shard's products bitwise the unsharded products' columns and within
    1e-4 x max of the plain products.  Returns {name: row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kv_sketch import tail_fold, tail_products
    from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs
    dev = flush.device
    out = {}
    G, N, Z, C, D, c0, Cl = FOLD_RANGE_GEOMETRY
    rows, pos, counts, tail, cf = fold_inputs(G, N, Z, C, D, dev, SEED + 40,
                                              True)
    whole = tail.clone()
    tail_fold(rows, pos, counts, whole, cf)
    part = tail[:, :, c0:c0 + Cl].contiguous()
    start = part.clone()
    tail_fold(rows, pos, counts, part, cf, c0, C)
    want = ref.tail_fold_ref(rows, pos, counts, start.clone(), cf, c0, C)
    torch.cuda.synchronize()
    if not torch.equal(part, whole[:, :, c0:c0 + Cl]):
        fail("tail_fold column range: not bitwise the unsharded fold's "
             "columns")
    err = (part - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    if not err <= tol:
        fail(f"tail_fold column range: max err {err} (tol {tol})")
    kernel_ms = device_ms(lambda: tail_fold(rows, pos, counts, part, cf, c0,
                                            C), 50, flush)[0]
    scratch = start.clone()
    plain_ms = device_ms(lambda: ref.tail_fold_ref(
        rows, pos, counts, scratch, cf, c0, C), 10, flush)[0]
    bk, sg = row_buckets_signs(cf, pos.reshape(-1), C, signed=True)
    valid = (torch.arange(N, device=dev)[None, :]
             < counts[:, None]).reshape(1, -1).expand(Z, -1)
    mine = valid & (bk >= c0) & (bk < c0 + Cl)                # (Z, G*N)
    g = torch.arange(G, device=dev).repeat_interleave(N)[None, :]
    flat = ((g * Z + torch.arange(Z, device=dev)[:, None]) * Cl
            + bk - c0)[mine]
    vals = (sg[:, :, None] * rows.reshape(1, G * N, D).float()
            .expand(Z, -1, -1))[mine]
    table = start.reshape(G * Z * Cl, D).clone()
    library_ms = device_ms(lambda: table.index_add_(0, flat, vals), 50,
                           flush)[0]
    # bytes: the valid rows with a bucket in the range read once, each
    # touched table row of the shard read and written once, positions and
    # counts read once; one add per (row, hash row) in the range
    needed = int(mine.any(dim=0).sum())
    touched = int(torch.unique(flat).numel())
    nbytes = needed * D * 2 + touched * D * 4 * 2 + G * N * 4 + G * 4
    b_ms, by = bound(nbytes, int(mine.sum()) * D)
    out["tail_fold_cols"] = dict(
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=b_ms, bound_by=by, max_abs_err=err)
    print(f"[kernel] tail_fold column range (G={G}, N={N}, Z={Z}, columns "
          f"[{c0}, {c0 + Cl}) of C={C}, D={D}): bitwise the unsharded "
          f"fold's columns; max|err| {err:.3e} vs the plain range fold "
          f"(tol {tol:.3e}) kernel_ms={kernel_ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={library_ms:.5f} (index_add_ of the "
          f"range's {int(mine.sum())} terms) bound_ms={b_ms:.6f} ({nbytes} "
          f"B: {needed} rows, {touched} table rows touched)")
    del rows, pos, counts, tail, whole, part, start, want, scratch, table
    B, K, Nq, hd, Z, C, c0, Cl = PRODUCTS_GEOMETRY
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    q = torch.randn((B, K, Nq, hd), generator=gen, device=dev)
    tk = torch.randn((B, Z, C, K, hd), generator=gen, device=dev)
    shard = tk[:, :, c0:c0 + Cl].contiguous()
    got = tail_products(q, shard)
    whole = tail_products(q, tk)
    want = ref.tail_products_ref(q, shard)
    torch.cuda.synchronize()
    if not torch.equal(got, whole[..., c0:c0 + Cl]):
        fail("tail_products on a column shard: not bitwise the unsharded "
             "products' columns")
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    if not err <= tol:
        fail(f"tail_products on a column shard: max err {err} (tol {tol})")
    kernel_ms = device_ms(lambda: tail_products(q, shard), 50, flush)[0]
    plain_ms = device_ms(lambda: ref.tail_products_ref(q, shard), 10,
                         flush)[0]
    # the same products as one f32 batched matmul (TF32 is off in main)
    q3, tkv = q[:, :, None], shard.permute(0, 3, 1, 4, 2)
    library_ms = device_ms(lambda: torch.matmul(q3, tkv), 50, flush)[0]
    nbytes = (q.numel() + shard.numel() + got.numel()) * 4
    flops = 2 * B * K * Z * Nq * Cl * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    out["tail_products_cols"] = dict(
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        max_abs_err=err)
    print(f"[kernel] tail_products on a column shard (B={B}, K={K}, N={Nq}, "
          f"hd={hd}, Z={Z}, columns [{c0}, {c0 + Cl}) of C={C}): bitwise "
          f"the unsharded products' columns; max|err| {err:.3e} vs the "
          f"plain products (tol {tol:.3e}) kernel_ms={kernel_ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} (f32 "
          f"torch.matmul) bound_ms={max(t_bytes, t_ops):.6f} ({nbytes} "
          f"B, {flops} flop in 3xTF32)")
    del q, tk, shard, got, whole, want, q3, tkv
    torch.cuda.empty_cache()
    return out


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
# cpd/rtpm.py:cs_oracle) and the FCS tiuu's CS of 15 inits; a J past
# the shared-memory accumulators (J-slabs); then the speculative path's:
# the compressed draft's weight sketches at gemma-2b's leaf shapes (W^T's
# d_out rows over d_in, 3 hash rows, ratio 4), its sketched head (the
# tied embedding's 256,000 rows over d_model, bf16) and the head's
# activation sketch of the 8 rows of a draft micro-step
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
    "draft_w_gate_up": (3, 16384, 2048, 512, F32),
    "draft_w_down": (3, 2048, 16384, 4096, F32),
    "draft_wq_wo": (3, 2048, 2048, 512, F32),
    "draft_wk_wv": (3, 256, 2048, 512, F32),
    "head_weights": (0, 256_000, 2048, 512, BF16),
    "head_sketch_decode": (0, 8, 2048, 512, BF16),
}
CS_MAIN = "cs_tiuu_fig1"
# name: (D, B, I, J, y per repetition): the six reference shapes, then
# Fig. 5's decompress at cr 2 (the 2,400,000 entries of A (x) B read from
# 20 sketches of 1,199,997), the FCS tiuu's lookup at Fig. 1 and the
# compressed draft's reconstructions at gemma-2b's leaf shapes
UNSKETCH_GEOMETRIES = {
    "ref_1x64_J32": (0, 1, 64, 32, False),
    "ref_4x1000_J256": (0, 4, 1000, 256, False),
    "ref_2x300_J64": (0, 2, 300, 64, False),
    "ref_8x4096_J512": (0, 8, 4096, 512, False),
    "ref_1x50_J300": (0, 1, 50, 300, False),
    "ref_3x128_J128": (0, 3, 128, 128, False),
    "kron_fig5_cr2": (20, 1, 2_400_000, 1_199_997, True),
    "fcs_tiuu_fig1": (2, 15, 100, 29_998, True),
    "draft_w_gate_up": (3, 16384, 2048, 512, True),
    "draft_w_down": (3, 2048, 16384, 4096, True),
    "draft_wq_wo": (3, 2048, 2048, 512, True),
    "draft_wk_wv": (3, 256, 2048, 512, True),
}
UNSKETCH_MAIN = "kron_fig5_cr2"
# name: (D, B, I, J) of the one-chunk count sketch (``chunks=1``, the
# order of additions fixed by the hash and (I, J)) that the sketched tail
# span makes of its softmax weights (serve/kv_sketch.py:tail_attend): the
# 8k decode step's 8 slots x 8 query heads, a verify step's at spec_k 2
# and a 256-token prefill chunk's 8 heads, over the T 8192 positions into
# C 1024 buckets, 3 hash rows
CS_ONE_CHUNK = {
    "tail_weights_decode": (3, 64, 8192, 1024),
    "tail_weights_verify_k2": (3, 192, 8192, 1024),
    "tail_weights_prefill": (3, 2048, 8192, 1024),
}


def draft_sketch_shapes(cfg, ratio, rows=3, batch=8):
    """The count_sketch and unsketch launches (D, B, I, J) that deriving
    ``cfg``'s count-sketch-compressed draft at ``ratio`` makes
    (models/draft.py): each matrix of a layer (each expert slice of a moe
    stack, the router, the shared experts) sketched as W^T's d_out rows
    over d_in, then reconstructed; the sketched head's weights (D 0, the
    (Vp, d) bf16 head or tied embedding) and the activation sketch of a
    draft micro-step's ``batch`` rows.  Returns ({name: count_sketch
    geometry}, {name: unsketch geometry})."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    mats = [(d, H * hd), (d, K * hd), (H * hd, d)]
    if cfg.family == "moe":
        m = cfg.moe
        f, fs = m.expert_d_ff, m.num_shared_experts * m.expert_d_ff
        mats += [(d, m.num_experts), (d, f), (f, d)]
        if fs:
            mats += [(d, fs), (fs, d)]
    else:
        mats += [(d, cfg.d_ff), (cfg.d_ff, d)]
    cs, un = {}, {}
    for d_in, d_out in mats:
        J = max(1, d_in // ratio)
        if J < d_in:
            cs[f"{d_out}x{d_in}_J{J}"] = (rows, d_out, d_in, J, F32)
            un[f"{d_out}x{d_in}_J{J}"] = (rows, d_out, d_in, J, True)
    J = d // ratio
    cs[f"head_{cfg.padded_vocab}x{d}_J{J}"] = (0, cfg.padded_vocab, d, J,
                                              BF16)
    cs[f"head_sketch_{batch}x{d}_J{J}"] = (0, batch, d, J, BF16)
    return cs, un


def add_draft_geometries(cfgs):
    """Add to the count_sketch and unsketch geometry tables every launch
    shape of phase moe-spec's compressed drafts (``draft_sketch_shapes``
    of each (arch, cfg) at MOE_SPEC_RATIO) that they do not hold yet."""
    for arch, cfg in cfgs:
        cs, un = draft_sketch_shapes(cfg, MOE_SPEC_RATIO)
        tag = arch.split("-")[0].split(".")[0]
        for table, new in ((CS_GEOMETRIES, cs), (UNSKETCH_GEOMETRIES, un)):
            for name, g in new.items():
                if g not in table.values():
                    table[f"draft_{tag}_{name}"] = g


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
    for gi, (name, (D, B, I, J)) in enumerate(CS_ONE_CHUNK.items()):
        gen = torch.Generator(dev).manual_seed(SEED + 60 + gi)
        x = torch.rand((B, I), generator=gen, device=dev)
        h, s = cs_tables(D, I, J, dev, gen)
        idx = bucket_links(h, s, J)
        got = count_sketch(x, h, s, J, idx, chunks=1)
        torch.cuda.synchronize()
        want = ref.count_sketch_ref(x, h, s, J)
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        if not err <= tol or not torch.equal(
                got, ref.count_sketch_tiled_ref(x, h, s, J, chunks=1)):
            fail(f"count_sketch {name}: max err {err} (tol {tol}) or not "
                 f"bitwise its one-chunk tiled model")
        kernel_ms = device_ms(lambda: count_sketch(x, h, s, J, idx,
                                                   chunks=1), 50, flush)[0]
        plain_ms = device_ms(lambda: ref.count_sketch_ref(x, h, s, J), 10,
                             flush)[0]
        flat = (h.long() + J * torch.arange(D, device=dev)[:, None]
                ).reshape(-1)
        sx = torch.cat([x * s[d] for d in range(D)], dim=1)
        table = torch.zeros((B, D * J), device=dev)
        library_ms = device_ms(lambda: table.index_add_(1, flat, sx), 50,
                               flush)[0]
        nbytes = B * I * 4 + D * I * 8 + D * B * J * 4
        bms, by = bound(nbytes, D * B * I)
        cs_rows[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bms,
                             bound_by=by, max_abs_err=err)
        print(f"[cs] count_sketch {name} (D={D}, B={B}, I={I}, J={J}, x "
              f"float32; one chunk, {plan(D, B, I, J, 4, 1).branch}): "
              f"max|err| {err:.3e} (tol 1e-5 x max|out| = {tol:.3e}; "
              f"bitwise its one-chunk tiled model) kernel_ms={kernel_ms:.5f}"
              f" plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"(index_add_) bound_ms={bms:.6f} ({by}, {nbytes} B)")
        del x, h, s, idx, sx, table, flat
    return cs_rows, un_rows


# ---------------------------------------------------------------------------
# phase 2, cpd: the paper core and CP decomposition at the paper's sizes
# ---------------------------------------------------------------------------


CS_KERNELS = ("count_sketch_kernel", "combine_kernel", "unsketch_kernel")


def traced(fn):
    """Run ``fn`` once under a CUDA-only profiler (CUPTI kernel records):
    (result, wall s ending in a synchronize, device busy s, {kernel:
    (device s, records)} for the count-sketch source's kernels), from
    ``kernel_records`` (a CS decomposition launches tens of thousands of
    kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, mine = 0.0, {k: [0.0, 0] for k in CS_KERNELS}
    for name, _, ns in kernel_records(prof):
        sec = ns / 1e9
        busy += sec
        for k in CS_KERNELS:
            if k in name:
                mine[k][0] += sec
                mine[k][1] += 1
    if busy <= 0:
        fail("the profiler recorded no device time in a traced run")
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

    def rtpm(self, T, T_cpu, method, hc, hashes, I, R, T_iters, inits,
             dev):
        """RTPM on the card from the first SHADOW_INITS of ``inits`` (R,
        L, I), every oracle call shadowed; a note."""
        from repro_torch.cpd.rtpm import make_oracle, rtpm
        k_or = make_oracle(T, method, hc)
        c_or = make_oracle(T_cpu, method, hashes)
        inits = inits[:, :SHADOW_INITS]
        rtpm(*(self.wrap(k, c, lambda a, p=p: vec_norm(a[0], p))
               for k, c, p in zip(k_or, c_or, (2, 3))), I, R,
             n_inits=inits.shape[1], n_iters=T_iters, inits=inits,
             device=dev)
        return (f"{self.calls} oracle calls of a card run from "
                f"{inits.shape[1]} of its inits repeated on the CPU within "
                f"tol (worst {self.worst:.3f} of tol)")


# the shadowed RTPM runs start from this many of the path run's L inits:
# an oracle call takes every init's vector at once, so a run from 5 makes
# as many calls as the 15-init run (420), each a third as wide on the CPU
# (FFT correlations at J up to 10000: host time, which a shared host
# stretches), each held alike
SHADOW_INITS = 5


def vec_norm(u, power):
    """max over the rows of u of ||u_row||^power."""
    return u.norm(dim=-1).max().item() ** power


# the sketched runs held bitwise to a second run of themselves: Fig. 1's
# TS and FCS at J 1000, ALS's at J 1500 (their sketches of T add in a fixed
# order, sketch/csvec.py:index_add_ordered_)
CPD_REPEAT = (1000, 1500)


def repeat_run(what, first, again):
    """A sketched CPD run and its repeat from the same inits and hashes:
    every output tensor bitwise."""
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{what}: a second run from the same inits and hashes differs "
             f"from the first")
    return "a second run bitwise the first"


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
                Tn, Tn_cpu, method, hc, hashes, I, R, T, inits, dev)
            if J == CPD_REPEAT[0]:
                note += "; " + repeat_run(f"fig1 {method} J={J}", (lams, U),
                                          decompose(Tn, R, method, J, D, L,
                                                    T, gen, hashes=hc,
                                                    inits=inits)[:2])
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
                Tn2, Tn2_cpu, method, hc, hashes, 50, R, T, inits, dev)
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
        if J == CPD_REPEAT[1]:
            note = "; " + repeat_run(f"als {method} J={J}", (lam, *F),
                                     (lambda o: (o[0], *o[1]))(
                                         als.als_decompose(Tg, R, inits=ig,
                                                           hashes=hg, **on)))
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
    # where a decode step's time goes (8 slots, kernel path), at the
    # engine's padded row count and unpadded (the padding's cost)
    from repro_torch.models import layers as ly
    c = clone(cache)
    busy0 = device_ms(lambda: tf.decode_step(params, c, cur, pos, cfg,
                                             tables), 5, flush)[0]
    busy, by_name, wall = device_ms(
        lambda: tf.decode_step(params, c, cur, pos, cfg, tables,
                               rows=ly.padded_rows(B)), 5, flush)
    pa = sum(v for k, v in by_name.items() if "paged_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] decode_step B=8 at the engine's {ly.padded_rows(B)} "
          f"padded rows: wall {wall:.3f} ms/step, device busy {busy:.3f} ms "
          f"({100 * (1 - busy / wall):.1f}% idle; unpadded {busy0:.3f} ms "
          f"busy), paged_attention {pa:.4f} ms "
          f"({len(cfg and params['blocks'])} launches); top kernels "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    return diff


LONG = dict(max_seq=8192, window=1024, ratio=8, rows=3)
# phase long serves gemma-2b at full width cut to this many of its 18
# layers (phase model holds the sketched decode step at all 18): its
# eager twins launch every layer's kernels from the host, and the cut
# keeps the whole run well inside its time limit.  Of the launch shapes
# only tail_fold's G depends on the depth (FOLD_GEOMETRIES holds it at 4
# layers too).  Phase long-spec keeps all 18: there the depth-2
# draft proposes nothing the target accepts, and its tokens equal the
# plain engine's only then.  A sketched engine folds at chunk heads, an
# accepted proposal moves a spec engine's chunk heads and so which rows
# its queries see exactly: at 4 layers two proposals of 64 rounds were
# accepted and the tokens parted (ROADMAP Queue 1 #22)
LONG_LAYERS = 4


def cut_depth(cfg, params, layers):
    """``cfg`` and ``params`` at their first ``layers`` layers."""
    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, blocks=params["blocks"][:layers]))


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
    from repro_torch.models import layers as ly
    c = clone(cache)
    busy0 = device_ms(lambda: tf.decode_step(params, c, cur, pos, cfg,
                                             tables, sketch=sk), 5, flush)[0]
    busy, by_name, wall = device_ms(
        lambda: tf.decode_step(params, c, cur, pos, cfg, tables, sketch=sk,
                               rows=ly.padded_rows(B)), 5, flush)
    pa = sum(v for k, v in by_name.items() if "paged_attention" in k)
    ts = sum(v for k, v in by_name.items() if "scores_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] sketched decode_step B=8, T={T}, at the engine's "
          f"{ly.padded_rows(B)} padded rows: wall {wall:.3f} ms/step, device "
          f"busy {busy:.3f} ms ({100 * (1 - busy / wall):.1f}% idle; "
          f"unpadded {busy0:.3f} ms busy), paged_attention {pa:.4f} ms, "
          f"tail_scores {ts:.4f} ms; top kernels "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
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



def serve_stream(cfg):
    """The serve phase's engine knobs and its 16-request stream."""
    from repro_torch.launch.serve import make_request_stream
    serve = dataclasses.replace(cfg.serve, **SERVE)
    reqs = make_request_stream(cfg, np.random.RandomState(SEED + 2), 16, 3,
                               64, 192, 32, sampled_frac=0.25,
                               temperature=0.8, top_k=8)
    return serve, reqs


def phase_serve(cfg, params, dev, logit_gap):
    from repro_torch.serve.frontend import AsyncServeEngine
    serve, reqs = serve_stream(cfg)
    run = twin_streams(
        "serve", lambda graphs, obs=None: AsyncServeEngine(
            cfg, params, serve=serve, device=dev, graphs=graphs, obs=obs),
        reqs, dev, observe={})
    done, ttfts, wall = run["done"], run["ttfts"], run["wall"]
    launches = run["launches"]["paged_attention"]
    sched = run["sched"]
    st = run["stats"]
    ntok = sum(len(c.tokens) for c in done)
    ok = [c for c in done if c.status == "ok" and len(c.tokens) == 32
          and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
    if launches <= 0 or len(ok) != len(reqs) or run["leaked"] != 0 \
            or st.prefix_hits <= 0:
        fail(f"serve: launches {launches}, completed ok {len(ok)}/"
             f"{len(reqs)}, leaked blocks {run['leaked']}, prefix hits "
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
    n_sampled = sum(1 for r in reqs if r.temperature)
    print(f"[serve] gemma-2b full width, 16 requests ({n_sampled} sampled), "
          f"decode and prefill chunks replayed as CUDA graphs: {ntok} "
          f"tokens in "
          f"{wall:.4f}s = {ntok / wall:.2f} tok/s, TTFT p50 "
          f"{np.percentile(ttfts, 50) * 1e3:.2f} ms, mean decode "
          f"chunk {run['chunk']:.3f} ms ({run['chunks']} chunks of "
          f"{serve.decode_chunk} steps), peak reserved KV "
          f"{st.kv_peak_reserved_bytes} B, prefix hits {st.prefix_hits}/"
          f"{st.prefix_lookups}, leaked blocks 0, paged_attention launches "
          f"{launches}; greedy vs teacher-forced recompute: {exact}/{total} "
          f"tokens are its top-1, worst shortfall {worst:.2f} of tol; "
          f"{card()}")
    del run, sched
    torch.cuda.empty_cache()
    return launches


# prompt lengths of the 8k stream: one under the window (its fold_base
# stays 0 in a mixed batch), six greedy past it, one sampled
LONG_PROMPTS = (512, 2048, 2560, 3072, 3584, 4096, 4608, 6144)
LONG_NEW = 64
LONG_BLOCKS = 704           # < half the stream's 1696 blocks of rows


def long_stream(cfg):
    """The long phase's sketched engine knobs and its 8k stream."""
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
    return serve, reqs


def phase_long_serve(cfg, params, dev):
    from repro_torch.serve.frontend import AsyncServeEngine
    cfg, params = cut_depth(cfg, params, LONG_LAYERS)
    serve, reqs = long_stream(cfg)
    run = twin_streams(
        "long", lambda graphs, obs=None: AsyncServeEngine(
            cfg, params, serve=serve, device=dev, graphs=graphs, obs=obs),
        reqs, dev, observe=dict(fidelity_every=1))
    sched, done, ttfts, wall = (run["sched"], run["done"], run["ttfts"],
                                run["wall"])
    launches = {k: run["launches"][k] for k in (
        "tail_fold", "tail_scores", "paged_attention",
        # the tail span's one-chunk sketch of softmax weights
        "count_sketch")}
    st = run["stats"]
    ntok = sum(len(c.tokens) for c in done)
    ok = [c for c in done if c.status == "ok" and len(c.tokens) == LONG_NEW
          and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
    rows = sum(LONG_PROMPTS) + LONG_NEW * len(LONG_PROMPTS)
    row_bytes = sched.alloc.block_bytes // sched.block_size
    dense_stream = rows * row_bytes
    if len(ok) != len(reqs) or run["leaked"] != 0 or st.fold_rows <= 0 \
            or st.kv_peak_reserved_bytes >= dense_stream \
            or min(launches.values()) <= 0:
        fail(f"long serve: completed ok {len(ok)}/{len(reqs)}, leaked "
             f"blocks {run['leaked']}, fold rows {st.fold_rows}, peak "
             f"reserved {st.kv_peak_reserved_bytes} vs dense {dense_stream}, "
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
    print(f"[long] gemma-2b full width, depth cut to {LONG_LAYERS} layers, "
          f"max_seq {LONG['max_seq']}, sketched "
          f"KV window {LONG['window']} ratio {LONG['ratio']} rows "
          f"{LONG['rows']} (C={sched.tail_cols}, T={sched.tail_domain}), "
          f"decode and prefill chunks replayed as CUDA graphs: "
          f"{len(reqs)} requests, prompts {list(LONG_PROMPTS)} (the last "
          f"sampled), {LONG_NEW} new each: {ntok} tokens in {wall:.4f}s = "
          f"{ntok / wall:.2f} tok/s, TTFT p50 "
          f"{np.percentile(ttfts, 50) * 1e3:.2f} ms, mean decode chunk "
          f"{run['chunk']:.3f} ms ({run['chunks']} chunks of "
          f"{serve.decode_chunk} steps)")
    print(f"[long] fold rows {st.fold_rows}; tail bytes "
          f"{st.kv_sketch_tail_bytes}; exact-window bytes (every pool block "
          f"is a slot's exact window: no prompt is cached) peak reserved "
          f"{st.kv_peak_reserved_bytes} ({st.blocks_peak} of {LONG_BLOCKS} "
          f"blocks); dense-equivalent bytes: the stream's {rows} rows "
          f"{dense_stream}, the engine's max_batch x max_seq "
          f"{st.kv_dense_equiv_bytes}; peak allocated {run['peak']} B; "
          f"leaked blocks 0; "
          f"launches {launches}; greedy vs exact teacher-forced recompute: "
          f"unfolded {LONG_PROMPTS[0]}-token request {exact0}/{LONG_NEW} "
          f"top-1 (worst shortfall {short / tol:.2f} of tol), folded "
          f"{LONG_PROMPTS[1]}-token request {exact1}/{LONG_NEW} top-1 (worst "
          f"shortfall {short1 / tol1:.2f} of tol); {card()}")
    del run, sched
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4, spec: speculative decoding at full width
# ---------------------------------------------------------------------------

# the serve phase's engine geometry
SERVE = dict(max_batch=8, max_seq=512, kv_block_size=16, prefill_bucket=32,
             decode_chunk=8, prefix_block=16)
SPEC_K = 4
# the spec phase's engines serve gemma-2b at full width cut to this many
# of its 18 layers (its verify check runs all 18): the engines' eager
# twins are host-bound, and with the spec_k 8 engine and phase moe-spec
# the cut keeps the whole run inside its time limit.  No launch shape
# depends on the depth.
SPEC_LAYERS = 2
# name: (serve knobs, per-request spec_k cycled over the stream or None)
SPEC_ENGINES = {
    "truncated_depth1": (dict(spec_k=SPEC_K, draft_depth=1), None),
    "cs_depth1_ratio4": (dict(spec_k=SPEC_K, draft_depth=1,
                              draft_sketch_ratio=4), None),
    "mixed_k0_k4": (dict(spec_k=SPEC_K, draft_depth=1), (0, SPEC_K)),
    # 8 slots x 9 verify rows: past the decode step's 64 rows, the verify
    # step's row ops run in two slabs of them (models/layers.py)
    "truncated_k8": (dict(spec_k=8, draft_depth=1), None),
}
# verify steps held bitwise to decode steps at full width: spec_k 4, and
# spec_k 8, past the decode step's 64 rows; the device ms of a verify
# step is compared at spec_k 7 (64 rows, one slab) and 8 (two slabs)
VERIFY_KS = (SPEC_K, 8)
VERIFY_MS_KS = (7, 8)
SPEC_KERNELS = ("paged_attention", "count_sketch", "unsketch")


def kernel_counters():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from repro_torch.kernels.count_sketch import count_sketch, unsketch
    from repro_torch.kernels.kv_sketch import tail_fold, tail_scores
    from repro_torch.kernels.paged_attention import paged_attention
    return dict(paged_attention=paged_attention, count_sketch=count_sketch,
                unsketch=unsketch, tail_fold=tail_fold,
                tail_scores=tail_scores)


class LaunchShapes:
    """While active, records the shape of every call the port makes to a
    kernel wrapper (kernels/ops.py dispatches every launch of the serve
    paths), keyed as the kernel phases' geometry tables are, so the run
    can show that each shape the serve paths launched was held against
    its plain version.  Calls that take the plain version on the card
    (``use_kernel=False``) never reach the wrappers.  A decode or prefill
    chunk replayed as a CUDA graph calls no wrapper; its capture called
    each one once at every shape the variant launches (and the eager twins
    of the serve phases call them too), so every shape is still seen."""

    KEYS = {
        # (B, Sq, K, R, hd, bs, nb): the geometry less the pool size NB,
        # which no work or split depends on
        "paged_attention": lambda q, kp, vp, tables, *a:
            (*q.shape, kp.shape[1], tables.shape[1]),
        "tail_fold": lambda rows, pos, counts, tail, *a:
            (rows.shape[0], rows.shape[1], tail.shape[1], tail.shape[2],
             rows.shape[2]),
        "tail_scores": lambda q, tk, cf, T: (*q.shape, tk.shape[1],
                                             tk.shape[2], T),
        # (D, B, I, J, x dtype, chunks); D 0 is one 1-D table
        "count_sketch": lambda x, h, s, J, index=None, chunks=None:
            (0 if h.ndim == 1 else h.shape[0], *x.shape, J, x.dtype,
             chunks),
        # (D, B, I, J, y per repetition)
        "unsketch": lambda y, h, s: (0 if h.ndim == 1 else h.shape[0],
                                     y.shape[-2], h.shape[-1], y.shape[-1],
                                     y.ndim == 3),
    }

    def __enter__(self):
        from repro_torch.kernels import ops
        self.seen = {k: set() for k in self.KEYS}
        self._orig = {k: getattr(ops, k) for k in self.KEYS}
        for k, fn in self._orig.items():
            setattr(ops, k, self._recording(k, fn))
        return self

    def _recording(self, name, fn):
        key = self.KEYS[name]

        def call(*a, **kw):
            self.seen[name].add(tuple(key(*a, **kw)))
            return fn(*a, **kw)
        return call

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for k, fn in self._orig.items():
            setattr(ops, k, fn)

    @staticmethod
    def held():
        """kernel -> the shapes the kernel phases hold against the plain
        versions, in ``KEYS``' form."""
        return {
            "paged_attention": {g[:5] + g[6:] for g in GEOMETRIES.values()},
            "tail_fold": set(FOLD_GEOMETRIES.values()),
            "tail_scores": set(SCORE_GEOMETRIES.values()),
            "count_sketch": {(D, B, I, J, dt, None) for D, B, I, J, dt
                             in CS_GEOMETRIES.values()}
            | {(D, B, I, J, F32, 1) for D, B, I, J in CS_ONE_CHUNK.values()},
            "unsketch": set(UNSKETCH_GEOMETRIES.values()),
        }

    def check(self, what):
        held = self.held()
        missing = {k: sorted(map(str, v - held[k]))
                   for k, v in self.seen.items() if v - held[k]}
        if missing:
            fail(f"{what} launched kernels at shapes no kernel phase holds "
                 f"against the plain version: {missing}")
        print(f"[shapes] {what}: every kernel launch shape is one the "
              f"kernel phases hold against the plain version: "
              + "; ".join(f"{k} {sorted(map(str, v))}"
                          for k, v in self.seen.items() if v))


def gemm_rows(params, cfg, dev, B, C):
    """Whether library GEMM rows and a row reduction at M = B (decode) equal
    the same rows at M = B C (verify), unpadded and padded to the engine's
    row count (models/layers.py, row padding): reported, not gated (the
    verify check gates the model)."""
    from repro_torch.models import layers as ly
    g = torch.Generator(dev).manual_seed(SEED + 11)
    x = torch.randn((B * C, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    blk = params["blocks"][0]
    ffn = torch.randn((B * C, cfg.d_ff), generator=g, device=dev).to(
        torch.bfloat16)
    ops = {"wq": lambda a: a @ blk["attn"]["wq"],
           "wk": lambda a: a @ blk["attn"]["wk"],
           "wo": lambda a: a @ blk["attn"]["wo"],
           "w_gate": lambda a: a @ blk["ffn"]["w_gate"],
           "head": lambda a: a @ params["embed"].t(),
           "rms mean": lambda a: a.float().square().mean(-1)}
    rows = ly.padded_rows(B)
    out = []
    for name, op in list(ops.items()) + [
            ("w_down", lambda a: a @ blk["ffn"]["w_down"])]:
        xs = ffn if name == "w_down" else x
        plain = torch.equal(op(xs[:B]), op(xs)[:B])
        padded = torch.equal(op(ly.pad_rows(xs[:B], rows))[:B],
                             op(ly.pad_rows(xs, rows))[:B])
        out.append(f"{name} {plain}/{padded}")
    return (f"rows {B} of M {B} vs M {B * C} equal, unpadded/padded to "
            f"{rows}: " + ", ".join(out))


def verify_vs_decode(cfg, params, dev):
    """Full-width verify_step at each spec_k of VERIFY_KS against spec_k
    + 1 sequential decode_steps on identical caches of 8 slots (one
    idle), both at the engine's step rows (a verify step past them in
    slabs of them): logits and pool rows bitwise.  Returns the cache and
    inputs for ``verify_ms``."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    B, NB, bs, nbs = 8, 256, 16, 32
    rng = np.random.RandomState(SEED + 10)
    cache = tf.init_paged_cache(cfg, NB, bs, dev)
    tables = torch.full((B, nbs), NB, dtype=torch.int32, device=dev)
    lens = rng.randint(1, 300, B)
    lens[0] = 0
    nxt = 0
    for b in range(1, B):
        n = -(-(int(lens[b]) + max(VERIFY_KS) + 1) // bs)
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
    for k in VERIFY_KS:
        verify_check(cfg, params, dev, cache, tables, pos, lens,
                     torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                                 (B, k + 1)), device=dev))
    return cache, tables, pos, rng


def verify_check(cfg, params, dev, cache, tables, pos, lens, toks):
    """``verify_vs_decode`` at one spec_k: the verify step of ``toks``
    (B, spec_k + 1) and its decode steps on clones of ``cache``."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    B, C = toks.shape
    spec_k = C - 1
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    cv, cd = clone(cache), clone(cache)
    rows = ly.padded_rows(B)              # the engine's, for both steps
    lv, _ = tf.verify_step(params, cv, toks, pos, cfg, tables, rows=rows)
    for i in range(C):
        ld, _ = tf.decode_step(params, cd, toks[:, i:i + 1], pos + i, cfg,
                               tables, rows=rows)
        if not torch.equal(lv[:, i], ld):
            d = (lv[:, i] - ld).abs().max().item()
            fail(f"spec: verify logits at offset {i} differ from the decode "
                 f"step's (max {d}); {gemm_rows(params, cfg, dev, B, C)}")
    for k in ("k", "v"):
        if not torch.equal(cv["kv"][k], cd["kv"][k]):
            fail(f"spec: verify pool rows ({k}) differ from decode's")
    if not torch.isfinite(lv).all():
        fail("spec: verify logits not finite")
    slabs = ly.slab_rows(B * C, rows) // rows
    print(f"[spec] gemma-2b full width verify_step at spec_k {spec_k} (8 "
          f"slots, contexts {lens.tolist()}; {B * C} rows in {slabs} "
          f"slab(s) of {rows}): logits (B, {C}, V) and pool rows bitwise "
          f"{C} sequential decode_steps; "
          f"{gemm_rows(params, cfg, dev, B, C)}")
    del cv, cd


def verify_ms(cfg, params, dev, cache, tables, pos, rng):
    """Device ms of one full-width verify_step (8 slots, the engine's
    step rows) at each spec_k of VERIFY_MS_KS, on clones of ``cache``:
    the kernels' summed durations (``device_ms``: profiler kernel
    records, L2 flushed before each step), mean of 3 steps; the eager
    step's host launches take longer than its kernels."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    B = pos.shape[0]
    rows = ly.padded_rows(B)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    out = {}
    for k in VERIFY_MS_KS:
        toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, k + 1)),
                               device=dev)
        c = {"kv": {n: v.clone() for n, v in cache["kv"].items()}}
        out[k] = device_ms(lambda: tf.verify_step(
            params, c, toks, pos, cfg, tables, rows=rows), 3, flush)[0]
        del c
    del flush
    print(f"[spec] gemma-2b full width verify_step device ms (8 slots, "
          f"profiler kernel records, mean of 3): "
          + ", ".join(f"spec_k {k} ({B * (k + 1)} rows, "
                      f"{ly.slab_rows(B * (k + 1), rows) // rows} slab(s))"
                      f" {ms:.4f}" for k, ms in out.items())
          + f"; spec_k {VERIFY_MS_KS[1]} / {VERIFY_MS_KS[0]} = "
          f"{out[VERIFY_MS_KS[1]] / out[VERIFY_MS_KS[0]]:.3f}; {card()}")
    torch.cuda.empty_cache()
    return out


def drive_stream(front, reqs, profiled):
    """The serve phase's submission (all at once) through ``front``:
    (completions, ttfts, wall s, device busy s or None)."""
    from repro_torch.launch.serve import stream_requests
    run = lambda: asyncio.run(stream_requests(
        front, reqs, 0.0, 0.0, np.random.RandomState(SEED + 3)))
    if profiled:
        (done, ttfts), wall, busy, _ = traced(run)
        return done, ttfts, wall, busy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, ttfts = run()
    torch.cuda.synchronize()
    return done, ttfts, time.perf_counter() - t0, None


def leaked_blocks(sched):
    """Blocks still reserved once every prefix-cache entry is evicted."""
    leaked = sched.alloc.reserved - sched.prefix_cache.held_blocks()
    while sched.prefix_cache.evict_one():
        pass
    return leaked + sched.alloc.reserved


# ---------------------------------------------------------------------------
# the decode and prefill chunks as CUDA graphs: each serve phase graphed
# and eager
# ---------------------------------------------------------------------------

WINDOW_CHUNKS = 3       # decode chunks in a profiled decode window


def with_generators(reqs, dev):
    """``reqs`` with every sampled request drawing from a caller's
    generator seeded with its seed (fresh generators on each call)."""
    return [dataclasses.replace(r, generator=torch.Generator(
        dev).manual_seed(r.seed if r.seed is not None else r.rid))
        if r.temperature else r for r in reqs]


def chunk_log(sched):
    """Record each collected chunk's (tokens, emit flags) on the host: a
    copy of the chunk's output just before ``collect`` reads it."""
    log = []
    collect = sched.collect

    def spy():
        log.append(sched._inflight[0].cpu().numpy())
        return collect()

    sched.collect = spy
    return log


def decode_window(sched, reqs):
    """The engine's hot loop alone: up to max_batch of ``reqs`` admitted
    and prefilled, then up to WINDOW_CHUNKS dispatch / collect rounds
    (fewer if every request finishes first) under the CUDA-only
    profiler, then the rest drained.  Returns (busy ms, wall ms) per
    decode step of the window and a copy of the pool rows [:, :NB] (both
    pools of a spec engine; a recurrent engine's whole slot state) just
    after the window's prefill."""
    for r in reqs[:sched.serve.max_batch]:
        sched.submit(r)
    sched.admit_pending()
    if sched.is_kv:
        pools = [{k: t[:, :sched.num_blocks].clone()
                  for k, t in c["kv"].items()} for c in sched._pools()]
    else:
        pools = [_clone_tree(sched._state.cache)]

    def rounds():
        n = 0
        while n < WINDOW_CHUNKS and sched.dispatch():
            sched.collect()
            n += 1
        return n

    n, wall, busy, _ = traced(rounds)
    sched.drain()
    if n == 0:
        fail("decode window: no live slot to dispatch")
    steps = n * sched.serve.decode_chunk
    return 1e3 * busy / steps, 1e3 * wall / steps, pools


def run_twin(front, reqs, dev):
    """One engine through its phase's stream twice (the first pass timed,
    the second under the CUDA-only profiler, each with fresh caller
    generators) and a decode window: what the graphed engine and its eager
    twin are held equal on, and the figures of the ``[graphs]`` line."""
    sched = front.scheduler
    log = chunk_log(sched)
    counters = kernel_counters()
    gens = []
    streams = []
    for _ in range(2):
        streams.append(with_generators(reqs, dev))
        gens += [r.generator for r in streams[-1] if r.generator is not None]
    window = with_generators([dataclasses.replace(r, rid=r.rid + 10_000)
                              for r in reqs], dev)
    gens += [r.generator for r in window[:sched.serve.max_batch]
             if r.generator is not None]
    for c in counters.values():
        c.launches = 0                       # the stream's launches alone
    torch.cuda.reset_peak_memory_stats()
    done, ttfts, wall, _ = drive_stream(front, streams[0], False)
    tracer = None if front.obs is None else front.obs.tracer
    first_events = None if tracer is None else len(tracer)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = sched.stats()
    chunk_ms = list(sched.chunk_ms)
    prefill_ms = sched.prefill_chunk_ms()
    caps = [sched.decode_compilations]
    pcaps = [sched.prefill_compilations]
    done2, _, twall, busy = drive_stream(front, streams[1], True)
    caps.append(sched.decode_compilations)
    pcaps.append(sched.prefill_compilations)
    busy_step, wall_step, pools = decode_window(sched, window)
    torch.cuda.synchronize()
    g, pg = sched._graphs, sched._prefill_graphs
    out = dict(
        sched=sched, done=done, ttfts=ttfts, wall=wall, launches=launches,
        peak=peak, stats=stats, chunk=float(np.mean(chunk_ms)),
        chunks=len(chunk_ms), caps=caps, idle=1 - busy / twall,
        busy_step=busy_step, wall_step=wall_step, log=log,
        tokens=[{c.rid: c.tokens for c in d} for d in (done, done2)],
        order=[c.rid for c in sched.completed],
        launches_all={k: c.launches for k, c in counters.items()},
        gens=[t.get_state() for t in gens],
        tails=[c["tail"].clone() for c in sched._pools()]
        if sched.sketch_on else [],
        variants=[] if g is None else g.variants(),
        capture_s={} if g is None else dict(g.capture_s),
        pool=0 if g is None else g.pool_bytes(),
        pcaps=pcaps, prefill_ms=prefill_ms, pools=pools,
        pvariants=[] if pg is None else pg.variants(),
        preplays={} if pg is None else dict(pg.replays),
        pcapture_s={} if pg is None else dict(pg.capture_s),
        ppool=0 if pg is None else pg.pool_bytes(),
        pools_apart=pg is None or pg._pool != g._pool,
        gather_ms=None if pg is None else tail_gather_ms(sched),
        first_events=first_events)
    out["books"] = (sched.alloc.peak_reserved, sched.alloc.rc.tolist(),
                    sorted(sched.alloc._free))
    out["leaked"] = leaked_blocks(sched)
    return out


def tail_gather_ms(sched):
    """Device ms of the sketched prefill's per-chunk gather of one slot's
    tails, every pool's (``index_select`` on the slot axis, as its graph
    replays it), mean of 20 under CUDA events; None on a sketch-free
    engine."""
    if not sched.sketch_on:
        return None
    idx = torch.zeros((1,), dtype=torch.int64, device=sched.device)
    tails = [c["tail"] for c in sched._pools()]
    gather = lambda: [t.index_select(2, idx) for t in tails]
    gather()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(20):
        gather()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / 20


def flags_equal(glog, elog):
    """Every chunk's emit flags, and the tokens they flag, equal."""
    return len(glog) == len(elog) and all(
        np.array_equal(x[1], y[1])
        and np.array_equal(x[0][x[1] > 0], y[0][y[1] > 0])
        for x, y in zip(glog, elog))


def gens_equal(ggens, egens):
    """The callers' generator states equal."""
    return len(ggens) == len(egens) and all(
        torch.equal(a, b) for a, b in zip(ggens, egens))


def twin_differences(g, e):
    """What differs between two runs of one stream (``run_twin``), each
    held bitwise: tokens of both passes, completion order, every chunk's
    emit flags and the tokens they flag, allocator books, tail tables,
    pool rows [:, :NB] of both pools after the window's prefill and at
    the end, kernel launch counts, the callers' generator states."""
    bad = []
    if g["order"] != e["order"]:
        bad.append("completion order")
    for k, (a, b) in enumerate(zip(g["tokens"], e["tokens"])):
        if a.keys() != b.keys() or any(not np.array_equal(a[r], b[r])
                                       for r in a):
            bad.append(f"tokens of pass {k + 1}")
    if not flags_equal(g["log"], e["log"]):
        bad.append("emit flags or flagged tokens")
    if g["books"] != e["books"]:
        bad.append("allocator books")
    if len(g["tails"]) != len(e["tails"]) or not all(
            torch.equal(a, b) for a, b in zip(g["tails"], e["tails"])):
        bad.append("tail tables")
    gs, es = g["sched"], e["sched"]
    if len(g["pools"]) != len(e["pools"]) or not all(
            torch.equal(a[k], b[k]) for a, b in zip(g["pools"], e["pools"])
            for k in ("k", "v")):
        bad.append("pool rows after the window's prefill")
    if not all(torch.equal(a["kv"][k][:, :gs.num_blocks],
                           b["kv"][k][:, :es.num_blocks])
               for a, b in zip(gs._pools(), es._pools())
               for k in ("k", "v")):
        bad.append("pool rows at the end")
    if g["launches"] != e["launches"] or \
            g["launches_all"] != e["launches_all"]:
        bad.append(f"launches {g['launches']} / {e['launches']}")
    if not gens_equal(g["gens"], e["gens"]):
        bad.append("callers' generator states")
    return bad


def twin_streams(what, make_front, reqs, dev, observe=None):
    """Serve ``reqs`` through a graphed engine (``make_front(None)``, the
    card's default) and its eager twin (``make_front(False)``), each by
    ``run_twin``.  Fails unless the graphed engine equals its twin
    bitwise (``twin_differences``) and captured each decode and prefill
    variant it used once, none more on the second pass (prefill: 1 on a
    sketch-free engine, at most 2 on a sketched one), the prefill graphs
    in a pool apart from the decode graphs'.  With ``observe`` (the
    fidelity probe's knobs) the eager twin carries a full observer
    (``make_front(False, obs)``) and ``observed_twin`` runs one more
    graphed engine with one.  Prints the ``[graphs]`` line; returns the
    graphed run."""
    runs = {}
    for graphs in (None, False):
        runs[graphs] = run_twin(
            make_front(graphs) if observe is None or graphs is None
            else make_front(graphs, full_observer(observe)), reqs, dev)
    g, e = runs[None], runs[False]
    bad = twin_differences(g, e)
    used = len(g["sched"]._graphs.replays)
    if g["caps"] != [g["caps"][0]] * 2 or not 1 <= g["caps"][0] <= used \
            or e["caps"] != [0, 0]:
        bad.append(f"captures {g['caps']} (eager {e['caps']}) for {used} "
                   f"variants used")
    pused = len(g["preplays"])
    pmax = 2 if g["sched"].sketch_on else 1
    if g["pcaps"] != [g["pcaps"][0]] * 2 or g["pcaps"][0] != pused \
            or not 1 <= pused <= pmax or e["pcaps"] != [0, 0]:
        bad.append(f"prefill captures {g['pcaps']} (eager {e['pcaps']}) "
                   f"for {pused} variants used (at most {pmax})")
    if not g["pools_apart"] or g["ppool"] <= 0:
        bad.append(f"prefill graphs' pool ({g['ppool']} B) not apart from "
                   f"the decode graphs'")
    if not 0 < len(g["prefill_ms"]) == len(e["prefill_ms"]):
        bad.append(f"prefill chunks timed {len(g['prefill_ms'])} / "
                   f"{len(e['prefill_ms'])}")
    if g["leaked"] or e["leaked"]:
        bad.append(f"leaked blocks {g['leaked']} / {e['leaked']}")
    if bad:
        fail(f"{what}: the graphed engine differs from its eager twin: "
             + ", ".join(bad))
    def figures(r):
        ntok = sum(len(c.tokens) for c in r["done"])
        return dict(
            chunk=f"{r['chunk']:.3f}", busy=f"{r['busy_step']:.4f}",
            wall=f"{r['wall_step']:.4f}",
            widle=f"{100 * (1 - r['busy_step'] / r['wall_step']):.1f}",
            idle=f"{100 * r['idle']:.1f}", tok_s=f"{ntok / r['wall']:.2f}",
            ttft=f"{np.percentile(r['ttfts'], 50) * 1e3:.2f}",
            pf50=f"{np.percentile(r['prefill_ms'], 50):.3f}",
            pfmax=f"{max(r['prefill_ms']):.3f}")

    fg, fe = figures(g), figures(e)
    pair = {k: f"{fg[k]} / {fe[k]}" for k in fg}
    print(f"[graphs] {what}: variants "
          f"{', '.join(v.name for v in g['variants'])}; "
          f"decode_compilations {g['caps'][0]} after the first pass, "
          f"{g['caps'][1]} after the second, {used} after the decode window "
          f"(capture s: "
          + ", ".join(f"{v.name} {t:.3f}" for v, t in g["capture_s"].items())
          + f"); graphs' pool {g['pool']} B; prefill variants "
          f"{', '.join(v.name for v in g['pvariants'])}: "
          f"prefill_compilations {g['pcaps'][0]} after the first pass, "
          f"{g['pcaps'][1]} after the second, "
          f"{sum(g['preplays'].values())} prefill replays in all (capture "
          f"s: "
          + ", ".join(f"{v.name} {t:.3f}" for v, t in g["pcapture_s"].items())
          + f"); prefill graphs' own pool {g['ppool']} B"
          + ("" if g["gather_ms"] is None else
             f"; the sketched prefill's tail gather {g['gather_ms']:.4f} ms "
             f"per chunk (every pool)")
          + f"; graphed / eager twin: prefill chunk p50 {pair['pf50']} ms, "
          f"max {pair['pfmax']} ms (device, {len(g['prefill_ms'])} chunks "
          f"of the first pass), decode "
          f"chunk {pair['chunk']} ms (mean of {g['chunks']} chunks), busy "
          f"per decode step {pair['busy']} ms (wall {pair['wall']} ms, idle "
          f"{pair['widle']}% over up to {WINDOW_CHUNKS} chunks, "
          f"{min(len(reqs), g['sched'].serve.max_batch)} slots live), "
          f"stream idle {pair['idle']}% (second pass, profiled), "
          f"{pair['tok_s']} tok/s, TTFT p50 {pair['ttft']} ms (first pass, "
          f"captures included); bitwise equal: tokens of "
          f"{len(g['order'])} requests over both passes and the window, "
          f"emit flags of {len(g['log'])} chunks, completion order, "
          f"allocator books, {len(g['pools'])} pools' rows after the "
          f"window's prefill and at the end, {len(g['tails'])} tail "
          f"tables, launches "
          f"{g['launches_all']}, {len(g['gens'])} callers' generator "
          f"states; {card()}")
    if observe is not None:
        observed_twin(what, make_front, reqs, dev, observe, g, e)
    g["twin_stats"] = e["stats"]
    del runs[False], e
    torch.cuda.empty_cache()
    return g


# the counts an observer mirrors from EngineStats that differ between a
# graphed engine and its eager twin by design (CUDA graph captures)
CAPTURE_COUNTERS = ("engine.decode_compilations",
                    "engine.prefill_compilations")


def full_observer(observe):
    """An observer recording everything: every request traced, a metrics
    window every round, the fidelity probe at ``observe``'s cadence."""
    from repro_torch.obs import ServeObserver, Tracer
    return ServeObserver(tracer=Tracer(sample_rate=1.0),
                         metrics_interval=0.0, **observe)


def observer_totals(sched):
    """The scheduler's observer after a last window with the engine's
    final stats: ({counter: total}, {gauge: value}, {histogram:
    samples})."""
    obs = sched.obs
    obs.flush(sched.stats())
    reg = obs.registry
    return ({n: c.value for n, c in reg.counters.items()},
            {n: g.value for n, g in reg.gauges.items()},
            {n: h.count for n, h in reg.hists.items()})


def balanced_trace(tracer):
    """Write the trace to a temporary file, parse it back, and return
    (events, the (id, name) async spans left open or closed twice)."""
    from repro_torch.obs import write_trace
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        n = write_trace(tracer, path)
        with open(path) as fh:
            ev = json.load(fh)["traceEvents"]
    if len(ev) != n:
        fail(f"trace file holds {len(ev)} of {n} events")
    depth = {}
    for x in ev:
        if x["ph"] in ("b", "e"):
            k = (x["id"], x["name"])
            depth[k] = depth.get(k, 0) + (1 if x["ph"] == "b" else -1)
    return ev, sorted(k for k, v in depth.items() if v)


def host_split(events, wall_s):
    """A pass's wall split by its trace events: the pump's ``dispatch``
    spans (launching a decode replay; a capture lands in its variant's
    first), its ``collect`` spans (the wait for the chunk and the work
    queued behind it, then the tokens' accounting), the prefill chunks'
    host launch spans, and the rest of the wall (admission bookkeeping,
    delivery, the event loop), in ms."""
    ms = {n: np.array([x["dur"] / 1e3 for x in events
                       if x["ph"] == "X" and x["name"] == n])
          for n in ("dispatch", "collect", "prefill_chunk")}
    wall = 1e3 * wall_s
    rest = wall - sum(v.sum() for v in ms.values())
    q = lambda v: (f"{np.percentile(v, 50):.3f}/{np.percentile(v, 99):.3f}"
                   if len(v) else "-")
    pf = ms["prefill_chunk"]
    return (f"dispatch p50/p99 {q(ms['dispatch'])} ms (sum "
            f"{ms['dispatch'].sum():.3f} over {len(ms['dispatch'])} "
            f"rounds), collect p50/p99 {q(ms['collect'])} ms (sum "
            f"{ms['collect'].sum():.3f}), prefill host {pf.sum():.3f} ms "
            f"(sum over {len(pf)} chunks, p50/p99 {q(pf)}), rest of wall "
            f"{rest:.3f} of {wall:.3f} ms")


def observed_twin(what, make_front, reqs, dev, observe, g, e):
    """One more graphed engine, with a full observer, through the stream,
    passes and window ``g`` (the graphed engine without one) and ``e``
    (its eager twin, observed) ran.  Fails unless it equals ``g`` bitwise
    (``twin_differences``) with the same decode and prefill captures; its
    observer's counters and histogram samples equal the eager twin's (a
    hook caught inside a captured chunk would run once, at capture, and
    count less on the graphed engine) and agree with its own
    ``EngineStats``; the trace it writes parses with every async span
    closed and nothing dropped; a sketched engine's probe sampled the
    tails.  Prints the ``[obs]`` line: the first pass's host time split
    into the pump's dispatch and collect spans, the prefill chunks' host
    launch spans and the rest of the wall."""
    t0 = time.perf_counter()
    o = run_twin(make_front(None, full_observer(observe)), reqs, dev)
    added = time.perf_counter() - t0
    sched = o["sched"]
    bad = twin_differences(g, o)
    gs = g["sched"]
    if (o["caps"], o["pcaps"], sched.decode_compilations,
            sched.prefill_compilations) != (
            g["caps"], g["pcaps"], gs.decode_compilations,
            gs.prefill_compilations):
        bad.append(f"captures {o['caps']} / {o['pcaps']} against "
                   f"{g['caps']} / {g['pcaps']} unobserved")
    if o["leaked"]:
        bad.append(f"leaked blocks {o['leaked']}")
    oc, og, oh = observer_totals(sched)
    ec, eg, eh = observer_totals(e["sched"])
    apart = lambda c: {k: v for k, v in c.items()
                       if k not in CAPTURE_COUNTERS}
    if apart(oc) != apart(ec):
        diff = sorted(k for k in set(oc) | set(ec) if k not in
                      CAPTURE_COUNTERS and oc.get(k) != ec.get(k))
        bad.append("observer counters differ from the eager twin's: "
                   + ", ".join(f"{k} {oc.get(k)} / {ec.get(k)}"
                               for k in diff))
    if oh != eh or set(og) != set(eg):
        bad.append(f"histogram samples {oh} / {eh} or gauges differ from "
                   f"the eager twin's")
    st = sched.stats()
    for f in dataclasses.fields(st):
        name = f"engine.{f.name}"
        got = oc.get(name, og.get(name))
        if got != getattr(st, f.name):
            bad.append(f"{name} {got} against EngineStats "
                       f"{getattr(st, f.name)}")
    want = {
        "serve.requests_submitted": st.completed,
        "serve.requests_admitted": st.completed,
        "serve.completions.ok": st.completed,
        "serve.decode_rounds": st.decode_steps // sched.serve.decode_chunk,
        "serve.tokens_committed": sum(len(c.tokens)
                                      for c in sched.completed),
        "serve.prefill_chunks": len(sched.prefill_chunk_ms()),
        "serve.fold_rows": st.fold_rows,
        "prefix.hit": st.prefix_hits,
        "prefix.miss": st.prefix_lookups - st.prefix_hits,
        "prefix.admit": st.prefix_admitted,
        "prefix.evict": st.prefix_evicted}
    for k, v in want.items():
        if oc.get(k, 0.0) != v:
            bad.append(f"{k} {oc.get(k, 0.0)} against the engine's {v}")
    probes = oh.get("kv.tail_spread", 0)
    if observe.get("fidelity_every") and probes < 1:
        bad.append("the fidelity probe took no kv.tail_spread sample")
    tracer = sched.obs.tracer
    ev, unbalanced = balanced_trace(tracer)
    if unbalanced or tracer.dropped:
        bad.append(f"trace spans left open {unbalanced[:5]}, dropped "
                   f"{tracer.dropped}")
    if bad:
        fail(f"{what}: the observed graphed engine: " + ", ".join(bad))
    tok = lambda r: sum(len(c.tokens) for c in r["done"]) / r["wall"]
    print(f"[obs] {what}: first pass of the graphed engine with a full "
          f"observer (every request traced, a metrics window a round"
          + (f", fidelity probe every {observe['fidelity_every']} round"
             if observe.get("fidelity_every") else "")
          + f"): {host_split(ev[:o['first_events']], o['wall'])}; tok/s "
          f"on/off {tok(o):.2f} / "
          f"{tok(g):.2f}; bitwise the unobserved graphed engine, captures "
          f"{o['caps']} / {o['pcaps']} as its; {len(oc)} observer counters "
          f"and {len(oh)} histograms equal the observed eager twin's and "
          f"agree with EngineStats; trace {len(ev)} events, spans "
          f"balanced; kv.tail_spread samples {probes}; added "
          f"{added:.1f} s; {card()}")


def phase_spec(cfg, params, dev):
    """Speculative decoding at full width: the verify contract at full
    depth at spec_k 4 and 8 and a verify step's device ms at spec_k 7 and
    8, then, at SPEC_LAYERS layers, the serve phase's 16-request
    stream (and two requests whose whole prompt is a cached prefix)
    through a plain engine and four spec engines (truncated draft;
    count-sketch-compressed draft with the sketched head; per-request
    spec_k 0 / 4; spec_k 8, whose verify steps run past the decode
    step's rows), each graphed and as its
    eager twin (``twin_streams``: timed, then again under a CUDA-only
    profiler for its idle share, then a decode window).  Every greedy
    request's tokens must equal the plain engine's bitwise; no block
    leaks; prefix hits fork; the spec path launches the paged-attention,
    count_sketch and unsketch kernels."""
    from repro_torch.launch.serve import make_request_stream
    from repro_torch.models.draft import make_draft
    from repro_torch.serve.frontend import AsyncServeEngine
    held = verify_vs_decode(cfg, params, dev)
    verify_ms(cfg, params, dev, *held)
    del held
    torch.cuda.empty_cache()
    cfg, params = cut_depth(cfg, params, SPEC_LAYERS)
    base = dataclasses.replace(cfg.serve, **SERVE)
    from repro_torch.serve.scheduler import Request
    reqs = make_request_stream(cfg, np.random.RandomState(SEED + 2), 16, 3,
                               64, 192, 32, sampled_frac=0.25,
                               temperature=0.8, top_k=8)
    # two greedy requests whose whole prompt is a shared 64-token prefix:
    # their hit shares the block the first decode row writes, which a
    # spec engine forks
    reqs += [Request(rid=16 + i, tokens=reqs[i].tokens[:64].copy(),
                     max_new=32) for i in range(2)]
    counters = kernel_counters()
    launches = {k: 0 for k in SPEC_KERNELS}
    plain = None
    for name, (kw, per_req) in [("plain", ({}, None))] + list(
            SPEC_ENGINES.items()):
        sv = dataclasses.replace(base, **kw)
        stream = [dataclasses.replace(r, spec_k=per_req[i % len(per_req)])
                  for i, r in enumerate(reqs)] if per_req else reqs
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draft = make_draft(params, cfg, sv)
        torch.cuda.synchronize()
        derive_s = time.perf_counter() - t0
        mine = {k: counters[k].launches for k in SPEC_KERNELS}
        run = twin_streams(
            f"spec {name}", lambda graphs: AsyncServeEngine(
                cfg, params, serve=sv, device=dev, draft=draft,
                graphs=graphs), stream, dev)
        mine = {k: mine[k] + run["launches"][k] for k in SPEC_KERNELS}
        if name != "plain":
            for k in SPEC_KERNELS:
                launches[k] += mine[k]
        sched, done, ttfts, wall = (run["sched"], run["done"], run["ttfts"],
                                    run["wall"])
        st = run["stats"]
        got = {c.rid: c.tokens for c in done}
        ok = [c for c in done if c.status == "ok" and len(c.tokens) == 32
              and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
        if len(ok) != len(reqs) or run["leaked"] != 0 \
                or st.prefix_hits <= 0:
            fail(f"spec {name}: completed ok {len(ok)}/{len(reqs)}, leaked "
                 f"blocks {run['leaked']}, prefix hits {st.prefix_hits}")
        ntok = sum(len(c.tokens) for c in done)
        line = (f"[spec] {name} (graphed): {ntok} tokens in {wall:.4f}s = "
                f"{ntok / wall:.2f} tok/s, TTFT p50 "
                f"{np.percentile(ttfts, 50) * 1e3:.2f} ms, mean decode "
                f"chunk {run['chunk']:.3f} ms ({run['chunks']} chunks of "
                f"{sv.decode_chunk} {'rounds' if draft else 'steps'}); "
                f"second pass profiled: idle {100 * run['idle']:.1f}%; "
                f"prefix hits {st.prefix_hits}/{st.prefix_lookups}, leaked "
                f"blocks 0")
        forks = sched.forks
        del run, sched
        torch.cuda.empty_cache()
        if plain is None:
            plain = got
            print(line + f"; {card()}")
            continue
        greedy = [r.rid for r in reqs if not r.temperature]
        diff = [rid for rid in greedy
                if not np.array_equal(got[rid], plain[rid])]
        if diff:
            fail(f"spec {name}: greedy requests {diff} differ from the plain "
                 f"engine's tokens")
        if st.spec_rounds <= 0 or forks <= 0:
            fail(f"spec {name}: {st.spec_rounds} rounds, {forks} "
                 f"forks on {st.prefix_hits} prefix hits (two of them "
                 f"whole-prompt hits)")
        same_sampled = sum(np.array_equal(got[r.rid], plain[r.rid])
                           for r in reqs if r.temperature)
        print(line + f"; draft {draft.cfg.num_layers} layers (sketched "
              f"head {draft.cfg.sketch.sketched_head}) derived in "
              f"{derive_s:.3f}s; acceptance {st.acceptance_rate:.4f} "
              f"({st.spec_accepted}/{st.spec_proposed}), mean accepted run "
              f"{st.mean_accepted_run:.4f} over {st.spec_rounds} rounds; "
              f"{len(greedy)} greedy requests bitwise the plain engine's "
              f"(sampled {same_sampled}/{len(reqs) - len(greedy)} equal too);"
              f" {forks} copy-on-write forks over both passes and the "
              f"window; launches "
              + ", ".join(f"{k} {v}" for k, v in mine.items()))
    if min(launches.values()) <= 0:
        fail(f"spec: launches on the spec path {launches}")
    print(f"[spec] launches on the spec path (four spec engines, draft "
          f"derivation included): {launches}; {card()}")
    return launches


LONG_SPEC_NEW = 32


def phase_long_spec(cfg, params, dev):
    """The sketched speculative path at 8k: two prompts of 2048 and 4096
    tokens (window 1024, ratio 8, rows 3) through a sketched plain engine
    and a sketched spec engine (spec_k 2, truncated draft of depth 2) of
    the long phase's geometry, each graphed and as its eager twin
    (``twin_streams``): the spec engine's tokens bitwise the plain
    engine's, rows fold in both pools, no block leaks, and the spec path
    launches both tail kernels and the paged-attention kernel."""
    from repro_torch.serve.frontend import AsyncServeEngine
    from repro_torch.serve.scheduler import Request
    base = dataclasses.replace(
        cfg.serve, max_batch=8, max_seq=LONG["max_seq"], kv_block_size=16,
        prefill_bucket=256, decode_chunk=8, prefix_block=16,
        num_kv_blocks=LONG_BLOCKS, kv_sketch_window=LONG["window"],
        kv_sketch_ratio=LONG["ratio"], kv_sketch_rows=LONG["rows"])
    rng = np.random.RandomState(SEED + 8)
    reqs = [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, n).astype(
        np.int32), max_new=LONG_SPEC_NEW) for i, n in enumerate((2048, 4096))]
    out = {}
    for name, kw in (("plain", {}), ("spec", dict(spec_k=2, draft_depth=2))):
        sv = dataclasses.replace(base, **kw)
        run = twin_streams(
            f"long-spec {name}", lambda graphs: AsyncServeEngine(
                cfg, params, serve=sv, device=dev, graphs=graphs), reqs, dev)
        out[name] = dict(tokens={c.rid: c.tokens for c in run["done"]},
                         launches=run["launches"], st=run["stats"],
                         leaked=run["leaked"],
                         tails=[float(t.abs().sum()) for t in run["tails"]],
                         wall=run["wall"],
                         ntok=sum(len(c.tokens) for c in run["done"]))
        del run
        torch.cuda.empty_cache()
    sp = out["spec"]
    same = all(np.array_equal(sp["tokens"][r.rid], out["plain"]["tokens"][
        r.rid]) for r in reqs)
    lk = sp["launches"]
    if not same or sp["leaked"] or sp["st"].fold_rows <= 0 \
            or min(sp["tails"]) <= 0 or sp["st"].spec_rounds <= 0 \
            or min(lk[k] for k in ("tail_fold", "tail_scores",
                                   "paged_attention")) <= 0:
        fail(f"long spec: tokens equal {same}, leaked {sp['leaked']}, fold "
             f"rows {sp['st'].fold_rows}, tail sums {sp['tails']}, rounds "
             f"{sp['st'].spec_rounds}, launches {lk}")
    print(f"[long-spec] gemma-2b full width, max_seq {LONG['max_seq']}, "
          f"sketched KV window {LONG['window']} ratio {LONG['ratio']} rows "
          f"{LONG['rows']}, prompts 2048 / 4096, {LONG_SPEC_NEW} new each: "
          f"spec_k 2 (truncated draft, depth 2) tokens bitwise the sketched "
          f"plain engine's; fold rows {sp['st'].fold_rows} (target and "
          f"draft tails both hold folds: |sum| {sp['tails'][0]:.4e} / "
          f"{sp['tails'][1]:.4e}); tail bytes {sp['st'].kv_sketch_tail_bytes}"
          f"; acceptance {sp['st'].acceptance_rate:.4f} over "
          f"{sp['st'].spec_rounds} rounds; {sp['ntok'] / sp['wall']:.2f} "
          f"tok/s against the plain engine's "
          f"{out['plain']['ntok'] / out['plain']['wall']:.2f}; leaked "
          f"blocks 0; launches {lk}; {card()}")
    return lk


# ---------------------------------------------------------------------------
# phase 5: train
# ---------------------------------------------------------------------------


# the in-situ leaf's tables are also held bitwise to the ordered model
# (kernels/ref.py:sketch_accumulate_ordered_ref) up to this many elements
ORDERED_IN_SITU = 1 << 24


class TrainProbe:
    """``train(on_grads=...)`` hook.  In-situ check: at step 0 it copies
    the stacked leaf ``leaf``'s gradient, params and pre-step tables; at
    step 1, before that step's update, it holds the tables and params the
    kernel path produced against the plain version run on the copies, and
    the params bitwise against the plain path's from the tables the
    kernel made.  Breakdown: from the hook of step ``prof`` to the hook of
    step ``prof + 1`` (one step's work: that step's optimizer, then the
    next step's batch, forward and backward) it runs the profiler and
    sums device time by kernel, the sketch_update kernels by name.
    ``bound`` is the optimizer's least time a step for its sketched
    leaves: g, the tables read and written, and the params read and
    written (the fused form) or the estimates written (the estimates
    form), each once.  ``hooks`` {step: fn(params, grads, opt)} run last
    at their step's hook (after the profiler has stopped at prof + 1)."""

    def __init__(self, leaf="blocks/norm1", prof=2, lr=None, hooks=None):
        self.leaf, self.prof_step, self.hooks = leaf, prof, hooks or {}
        self.lr = TRAIN["lr"] if lr is None else lr
        self.saved = None
        self.report = None
        self.moment_bytes = None
        self.prof = None
        self.breakdown = None
        self.bound = None
        self.sketch_ms = None
        self.busy_ms = None
        self.window_ms = None
        self.opt_ms = None
        self.mem = []           # (allocated, peak so far) at each hook

    def __call__(self, step, params, grads, opt):
        self.mem.append((torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
        if step == self.prof_step + 1:
            self._stop()
        if step == 0:
            self._save(params, grads, opt)
        elif step == 1:
            self._check(params, opt)
        if step == self.prof_step:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            # kernels only: an eager sLSTM step's host records took the
            # profiler tens of seconds to collect
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        if step in self.hooks:
            self.hooks[step](params, grads, opt)

    def _stop(self):
        torch.cuda.synchronize()
        wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        events = kernel_records(self.prof)
        self.prof = None
        by_name = {}
        for name, _, ns in events:
            by_name[name] = by_name.get(name, 0.0) + ns / 1e6
        busy = sum(by_name.values())
        if busy <= 0:
            fail("the profiler recorded no device time in the train step")
        split = sketch_split(by_name)
        sk = sum(split.values())
        gemm = sum(v for k, v in by_name.items()
                   if any(f in k.lower() for f in (
                       "gemm", "xmma", "cutlass", "nvjet")))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        # the optimizer's span: from the window's start (the step's update
        # follows the hook) to the end of the last sketch_update kernel;
        # what else runs in it is the dense leaves' and (per-piece form)
        # the elementwise AdamW math and the coefficient casts
        last = max((i for i, (name, _, _) in enumerate(events)
                    if sketch_kernel(name)), default=-1)
        span = events[:last + 1]
        opt_ms = sum(ns for _, _, ns in span) / 1e6
        self.sketch_ms, self.busy_ms, self.window_ms = sk, busy, wall
        self.opt_ms = opt_ms
        self.breakdown = (
            f"one step under the profiler (step {self.prof_step}'s "
            f"optimizer + step {self.prof_step + 1}'s forward/backward): "
            f"wall {wall:.3f} ms, device busy "
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

    def _leaf(self, tree):
        from repro_torch.models.transformer import param_leaves
        names = [n for n, _ in param_leaves(tree)]
        i = names.index(self.leaf)
        return i, param_leaves(tree)[i][1]

    def _save(self, params, grads, opt):
        from repro_torch.models.transformer import param_leaves
        from repro_torch.sketch.optimizer import moment_state_bytes
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
        i, gs = self._leaf(grads)
        mo = opt.moments[i]
        if not hasattr(mo.m, "table"):
            fail(f"in-situ leaf {self.leaf} is not sketched")
        self.saved = dict(g=[t.clone() for t in gs],
                          p=[t.clone() for t in self._leaf(params)[1]],
                          m=mo.m.table.clone(), v=mo.v.table.clone())

    def _check(self, params, opt):
        from repro_torch.kernels import ref
        from repro_torch.train.optimizer import bias_corrections
        sv = self.saved
        i, now_p = self._leaf(params)
        mo = opt.moments[i]
        off, pieces = 0, []
        for t in sv["g"]:
            pieces.append((t.reshape(-1), off))
            off += t.numel()
        new_m, new_v = ref.sketch_accumulate_ref(
            pieces, sv["m"], sv["v"], mo.m.coeffs, mo.v.coeffs, B1, B2)
        ordered = off <= ORDERED_IN_SITU
        if ordered:
            om, ov = ref.sketch_accumulate_ordered_ref(
                pieces, sv["m"], sv["v"], mo.m.coeffs, mo.v.coeffs, B1, B2)
            if not (torch.equal(om, mo.m.table)
                    and torch.equal(ov, mo.v.table)):
                fail(f"in-situ {self.leaf}: the kernel's tables differ from "
                     f"the ordered model's")
            del om, ov
        bc1, bc2 = bias_corrections(B1, B2, 1)
        # from the tables the kernel made, the plain path's params bitwise
        # (before the loop below updates the saved params in place)
        same = []
        for p, now, (g, o) in zip(sv["p"], now_p, pieces):
            mh, vh = ref.sketch_retrieve_ref(g.numel(), o, mo.m.table,
                                             mo.v.table, mo.m.coeffs,
                                             mo.v.coeffs)
            q = p.clone()
            ref.sketched_leaf_update(q, mh, vh, lr=self.lr, eps=1e-8,
                                     weight_decay=0.01, bc1=bc1, bc2=bc2)
            same.append(torch.equal(q, now))
            del mh, vh, q
        if not all(same):
            fail(f"in-situ {self.leaf} params: {same.count(False)} pieces "
                 f"differ from the plain path's given the kernel's tables")
        for p, (g, o) in zip(sv["p"], pieces):
            mh, vh = ref.sketch_retrieve_ref(g.numel(), o, new_m, new_v,
                                             mo.m.coeffs, mo.v.coeffs)
            ref.sketched_leaf_update(p, mh, vh, lr=self.lr, eps=1e-8,
                                     weight_decay=0.01, bc1=bc1, bc2=bc2)
            del mh, vh
        err_t = max(close_to(mo.m.table, new_m, f"in-situ {self.leaf} m "
                             f"table"),
                    close_to(mo.v.table, new_v, f"in-situ {self.leaf} v "
                             f"table"))
        err_p = 0.0
        top = max(w.float().abs().max().item() for w in sv["p"])
        for got, want in zip(now_p, sv["p"]):
            got, want = got.float(), want.float()
            err_p = max(err_p, (got - want).abs().max().item())
            if not torch.allclose(got, want, rtol=2 ** -7,
                                  atol=2 ** -9 * top):
                fail(f"in-situ {self.leaf} params: max err {err_p} (one "
                     f"bf16 ulp allowed)")
        self.report = (f"in-situ step-1 {self.leaf} ({len(pieces)} pieces "
                       f"of {tuple(sv['g'][0].shape)}, tables "
                       f"{tuple(new_m.shape)}) kernel vs plain: tables "
                       f"max|err| {err_t:.3e}, params max|err| {err_p:.3e} "
                       f"(one bf16 ulp allowed)"
                       + ("; tables bitwise the ordered model's" if ordered
                          else "")
                       + "; from the kernel's tables the params bitwise the "
                       "plain path's")
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
    kept = {}

    def keep(params, grads, opt):   # updated in place by the last step
        kept.update(params=params, opt=opt)

    probe = TrainProbe(hooks={TRAIN["steps"] - 1: keep})
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
    del hist, probe
    gc.collect()
    torch.cuda.empty_cache()
    k4 = train_4k(cfg, kept.pop("params"), kept.pop("opt"), dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_compressed(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=RESUME["layers"])
    print(f"[train] {resume_check('train', cut, dev)}", flush=True)
    print(f"[train] compressed (ratio {cfg.sketch.grad_hash_ratio}) "
          f"{resume_check('train compressed', cut, dev, grad_compression=True)}",
          flush=True)
    return launches, k4


# the resume checks: RESUME["steps"] straight steps, then a run that
# checkpoints at step ``ckpt`` through train/checkpoint.py, crashes at
# ``crash`` and resumes from the checkpoint; yi-9b (sketched, and
# FCS-compressed) at phase launch's depth in phase train, granite-moe at
# the same depth in phase train-families
RESUME = dict(steps=4, ckpt=2, crash=3, layers=4)


def resume_check(what, cfg, dev, **kw):
    """``cfg`` through train/loop.py ``RESUME["steps"]`` steps straight,
    then crashed and resumed (a temporary checkpoint directory): the
    resumed losses, params, moment tables and step counter must be
    bitwise the straight run's.  Returns the report line."""
    import shutil
    import tempfile
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import train
    n = RESUME["steps"]
    run = dict(steps=n, batch=TRAIN["batch"], seq=TRAIN["seq"],
               lr=TRAIN["lr"], seed=SEED, device=dev, log_every=n + 1,
               log_fn=lambda _: None, **kw)
    final = {}

    def keep(tag):      # the last step updates params and opt in place
        def hook(step, params, grads, opt):
            if step == n - 1:
                final[tag] = {"params": params, "opt": opt}
        return hook

    laps = [time.perf_counter()]
    straight = train(cfg, on_grads=keep("straight"), **run)
    laps.append(time.perf_counter())
    d = tempfile.mkdtemp(prefix="resume_check_")
    try:
        crashed = False
        try:
            train(cfg, ckpt_dir=d, ckpt_every=RESUME["ckpt"],
                  crash_at_step=RESUME["crash"], **run)
        except RuntimeError as e:
            crashed = "injected crash" in str(e)
        laps.append(time.perf_counter())
        saved = ckpt_lib.latest_step(d)
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        resumed = train(cfg, ckpt_dir=d, ckpt_every=n + 1, resume=True,
                        on_grads=keep("resumed"), **run)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    laps.append(time.perf_counter())
    secs = laps[-1] - laps[0]
    split = " / ".join(f"{b - a:.1f}" for a, b in zip(laps, laps[1:]))
    a = ckpt_lib._leaves(final["straight"])
    b = ckpt_lib._leaves(final["resumed"])
    names = [x for x, _, _ in a]
    differ = [x for (x, u, _), (_, w, _) in zip(a, b)
              if (u != w if isinstance(u, int) else not same_bits(u, w))]
    tensors = sum(not isinstance(u, int) for _, u, _ in a)
    if not crashed or saved != RESUME["ckpt"] \
            or names != [x for x, _, _ in b] or differ \
            or resumed.losses != straight.losses[RESUME["ckpt"]:]:
        fail(f"{what} resume: crashed {crashed}, checkpoint at {saved}, "
             f"losses {resumed.losses} vs {straight.losses}, leaves that "
             f"differ {differ[:8]} ({len(differ)})")
    return (f"resume: {cfg.name} ({cfg.num_layers} layers), {n} steps "
            f"straight, then checkpointed at step {RESUME['ckpt']} "
            f"({nbytes} B through train/checkpoint.py), crashed at "
            f"{RESUME['crash']} and resumed: losses "
            + ", ".join(f"{x:.6f}" for x in resumed.losses)
            + f" bitwise the straight run's; all {tensors} param and "
            f"moment tensors and the step counter bitwise; {secs:.1f}s "
            f"(straight / crashed, with the checkpoint / resumed: {split}); "
            f"{card()}")



# the 4096-token part of phase train: the reference's train_4k context on
# the same model and optimizer state; batch 4 if the walk's estimate of
# that step at a mesh of one (arguments and activations) plus the moment
# state is at most ``cap`` bytes, else 2
TRAIN_4K = dict(steps=2, seq=4096, batches=(4, 2), cap=72e9)
# one layer's KV-chunked attention against a dense f32 S x S version:
# output and gradients, fractions of max|dense| (the chunked form rounds
# its scores, its probabilities and each product to bf16, as the
# reference does)
ATTN_GATE = (0.02, 0.05)


def walk_estimates():
    """The dry run's train-4k cells, the first its process prints, read
    as they come (``collect_dryrun`` reads the rest)."""
    if "proc" not in _DRYRUN:        # phase train run alone (tools/)
        start_dryrun(os.path.dirname(os.path.abspath(__file__)))
    early = _DRYRUN.setdefault("early", [])
    proc = _DRYRUN["proc"]
    while len(early) < len(TRAIN_4K["batches"]):
        ln = proc.stdout.readline()
        if not ln:
            fail(f"train-4k: the dry run ended (exit {proc.poll()}) before "
                 f"its train-4k cells")
        if ln.startswith("{"):
            early.append(json.loads(ln))
    bad = [c for c in early if c.get("status") != "ok"]
    if bad:
        fail(f"train-4k: dry-run cells {[(c['shape'], c.get('error')) for c in bad]}")
    return {c["cut"]["global_batch"]: c for c in early}


def dense_attention(p, x, cfg):
    """Causal attention of x (B, S, d) in f32 throughout: the projections
    and roped q, k, v, one softmax over the whole masked (B, H, S, S)
    scores; the plain version of the chunked form on the card."""
    from repro_torch.models import layers as ly
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q, k, v = ly._project_qkv_rope(p, x, cfg, torch.arange(S, device=x.device))
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                  device=x.device).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, S, H * hd) @ p["wo"]


def attention_gate(cfg, p, B, S, dev):
    """Layer ``p``'s causal_attention (kv_chunk 1024) at (B, S) in bf16
    against ``dense_attention`` in f32 from the same bf16 values (one
    sequence at a time): output, and the gradients of x and of every
    weight for a seeded cotangent.  Returns the max errors as fractions
    of max|dense| (output, then the largest over the gradients) and the
    chunked layer's forward + backward wall ms."""
    from repro_torch.models import layers as ly
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    names = sorted(p)
    leaves = {k: p[k].detach().clone().requires_grad_(True) for k in names}
    xx = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ly.causal_attention(leaves, xx, cfg)
    (o.float() * w).sum().backward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = [o.detach(), xx.grad] + [leaves[k].grad for k in names]
    del o, leaves, xx
    dl = {k: p[k].detach().float().requires_grad_(True) for k in names}
    outs, gx = [], []
    for b in range(B):
        xb = x[b:b + 1].float().requires_grad_(True)
        ob = dense_attention(dl, xb, cfg)
        (ob * w[b:b + 1]).sum().backward()
        outs.append(ob.detach())
        gx.append(xb.grad)
        del ob, xb
    want = [torch.cat(outs), torch.cat(gx)] + [dl[k].grad for k in names]
    errs = [float((a.float() - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    return errs[0], max(errs[1:]), wall


def train_4k(cfg, params, opt, dev):
    """The 4096-token steps of phase train on ``params`` and ``opt`` (see
    the module docstring).  Returns the sketch_update launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.models import model as M
    from repro_torch.sketch.optimizer import moment_state_bytes
    from repro_torch.train import data as data_lib
    from repro_torch.train.optimizer import make_optimizer
    t_part = time.perf_counter()
    walks = walk_estimates()
    state_b = moment_state_bytes(opt)["total"]
    est = {b: c["memory"]["peak_bytes_per_device"] + state_b
           for b, c in walks.items()}
    B = 4 if est[4] <= TRAIN_4K["cap"] else 2
    S = TRAIN_4K["seq"]
    step = M.make_train_step(cfg)
    _, update = make_optimizer(cfg, lr=TRAIN["lr"])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sketch_update.launches = 0              # count the main path alone
    losses, times = [], []
    last = TRAIN_4K["steps"] - 1
    for i in range(TRAIN_4K["steps"]):
        batch = data_lib.make_batch(cfg, TRAIN["steps"] + i, B, S, SEED, dev)
        if i == last:
            fwd = forward_ms(cfg, params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == last:
            with profile(activities=[ProfilerActivity.CUDA]) as pf:
                loss, grads = step(params, batch)
                torch.cuda.synchronize()
            fb = sum(ns for _, _, ns in kernel_records(pf)) / 1e6
            with profile(activities=[ProfilerActivity.CUDA]) as pf:
                params, opt = update(grads, opt, params)
                torch.cuda.synchronize()
            by_name = {}
            for name, _, ns in kernel_records(pf):
                by_name[name] = by_name.get(name, 0.0) + ns / 1e6
            opt_ms = sum(by_name.values())
            sk = sum(sketch_split(by_name).values())
        else:
            loss, grads = step(params, batch)
            params, opt = update(grads, opt, params)
        del grads
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        del batch
    torch.cuda.synchronize()
    launches = sketch_update.launches
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    p0 = params["blocks"][0]["attn"]
    err_o, err_g, gate_ms = attention_gate(cfg, p0, B, S, dev)
    if not all(np.isfinite(losses)) or peak >= total or launches <= 0 \
            or err_o > ATTN_GATE[0] or err_g > ATTN_GATE[1]:
        fail(f"train-4k: losses {losses}, peak {peak} of {total} B, "
             f"sketch_update launches {launches}, attention vs dense "
             f"{err_o:.3g} / {err_g:.3g} (gate {ATTN_GATE})")
    tokens = B * S
    print(f"[train-4k] yi-9b full width and depth, the same model and "
          f"sketched AdamW state (ratio 4, rows 3) after the 8 x 128 steps: "
          f"batch {B} x {S} (the walk's estimate at batch 4: "
          f"{est[4]} B, cap {TRAIN_4K['cap']:.0f}), KV chunks of 1024: "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; step ms " + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" (the second profiled: forward + backward, then the "
          f"optimizer); {tokens / times[0]:.1f} tokens/s (step 0); device "
          f"ms: forward {fwd:.3f} (one forward without autograd), backward "
          f"{fb - fwd:.3f} (recomputes included: the profiled forward + "
          f"backward's busy {fb:.3f} less the forward), optimizer "
          f"{opt_ms:.3f} of which sketch_update {sk:.3f}; peak allocated "
          f"{peak} B ({peak / 2 ** 30:.2f} GiB; {base} B allocated at the "
          f"start) of the card's {total} B; the walk's estimate "
          + ", ".join(f"batch {b}: {e} B" for b, e in sorted(est.items()))
          + f" (its arguments and activations at a (1, 1) mesh, "
          + ", ".join(f"{c['memory']['peak_bytes_per_device']}" for _, c
                      in sorted(walks.items()))
          + f" B, walked in "
          + ", ".join(f"{c['t_walk_s']}" for _, c in sorted(walks.items()))
          + f" s, plus the moment state {state_b} B): ratio "
          f"{peak / est[B]:.4f}; sketch_update launches {launches}; "
          f"attention (layer 0) at ({B}, {S}) vs dense f32: output "
          f"{err_o:.3g}, gradients {err_g:.3g} of max|dense| (gate "
          f"{ATTN_GATE[0]} / {ATTN_GATE[1]}), chunked forward + backward "
          f"{gate_ms:.1f} ms wall; {time.perf_counter() - t_part:.1f}s; "
          f"{card()}", flush=True)
    del params, opt
    return launches


# the compressed yi-9b steps after the sketched-AdamW ones: the config's
# grad_hash_ratio (16); the leaf whose estimate is checked in situ
COMPRESS_STEPS = 2
COMPRESS_LEAF = "blocks/attn/wk"


class CompressProbe:
    """The compressed run's ``grad_compress.probe`` (called for every
    compressed leaf between its sketch and its estimate) and its
    ``on_grads`` hook.  It counts the leaves each step compresses.  At
    step 0 it copies ``COMPRESS_LEAF``'s raw gradient pieces, hashes and
    the main path's sketch, and at that step's hook holds the estimate the
    optimizer will apply bitwise to ``unsketch_leaf`` of that sketch, the
    sketch bitwise to ``sketch_leaf`` of the raw copy (the sketch adds in
    a fixed order: ``sketch/csvec.py:index_add_ordered_``), and the
    hashes to a fresh draw from (seed, step, leaf) bitwise.  At step 1's hook it times the
    compression of every leaf on copies of that step's gradient, leaf by
    leaf between CUDA events: the hash draw, the sketch and the
    estimate."""

    def __init__(self, cfg, leaf_id):
        self.cfg, self.leaf_id = cfg, leaf_id
        self.n = 0
        self.counts = []
        self.saved = None
        self.report = None
        self.ms = None
        self.bytes = 0
        self.codecs = None
        self.mem = []

    def compressed(self, c, pieces, tables, sk):
        self.n += 1
        if c.leaf_id == self.leaf_id and self.saved is None:
            self.saved = dict(c=c, raw=[p.clone() for p in pieces],
                              tables=tuple(t.clone() for t in tables),
                              sk=sk.clone())

    def __call__(self, step, params, grads, opt):
        from repro_torch.models.transformer import param_leaves
        from repro_torch.train import grad_compress as gcm
        self.mem.append((torch.cuda.memory_allocated(),
                         torch.cuda.max_memory_allocated()))
        self.counts.append(self.n)
        self.n = 0
        seed = self.cfg.sketch.seed
        if step == 0:
            self.codecs = [c for c in gcm._leaf_codecs(
                params, self.cfg.sketch.grad_hash_ratio) if c is not None]
            sv = self.saved
            c = sv["c"]
            est = param_leaves(grads)[c.leaf_id][1]
            want = gcm.unsketch_leaf(sv["sk"], c, sv["tables"], est,
                                     dtype=est[0].dtype)
            if not all(torch.equal(a, b) for a, b in zip(est, want)):
                fail(f"compressed {COMPRESS_LEAF}: the estimate differs from "
                     f"unsketch_leaf of the main path's sketch")
            again = gcm.codec_hashes(c, seed, 0, est[0].device)
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                         sv["tables"])):
                fail(f"compressed {COMPRESS_LEAF}: the hashes do not follow "
                     f"from (seed, step, leaf)")
            sk2 = gcm.sketch_leaf(sv["raw"], c, sv["tables"])
            differ = int((sk2 != sv["sk"]).sum())
            if differ:
                fail(f"compressed {COMPRESS_LEAF}: sketch_leaf of the raw "
                     f"gradient differs from the main path's sketch in "
                     f"{differ} of {c.Jt} buckets")
            self.report = (
                f"in-situ step-0 {COMPRESS_LEAF} ({len(est)} pieces of "
                f"{tuple(est[0].shape)}, I1 {c.I1}, k {c.k}, J~ {c.Jt}, pad "
                f"{c.pad}): the estimate bitwise unsketch_leaf of the main "
                f"path's sketch; sketch_leaf of the raw gradient bitwise "
                f"that sketch; hashes bitwise a fresh draw from (seed, "
                f"step, leaf)")
            self.saved = None
        elif step == 1:
            codecs = gcm._leaf_codecs(params, self.cfg.sketch.grad_hash_ratio)
            ms = [0.0, 0.0, 0.0, 0.0]
            for (_, pieces), c in zip(param_leaves(grads), codecs):
                if c is None:
                    continue
                copy = [p.clone() for p in pieces]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                torch.cuda.synchronize()
                ev[0].record()
                tables = gcm.codec_hashes(c, seed, 1, copy[0].device)
                ev[1].record()
                sk = gcm.sketch_leaf(copy, c, tables)
                ev[2].record()
                out = gcm.unsketch_leaf(sk, c, tables, copy,
                                        dtype=copy[0].dtype)
                ev[3].record()
                # the element-by-element index_add_ the sketch replaced
                # (f32 atomics in a varying order), timed as its yardstick
                old = torch.zeros_like(sk)
                for g, pos, sign in gcm._chunks(copy, c, tables):
                    old.index_add_(0, pos, g.float() * sign)
                ev[4].record()
                torch.cuda.synchronize()
                for j in range(4):
                    ms[j] += ev[j].elapsed_time(ev[j + 1])
                del old
                n = sum(p.numel() for p in pieces)
                # g read, the estimate written, h1 and s1 written and read,
                # the sketch written and read, each once
                self.bytes += (2 * n * pieces[0].element_size()
                               + 2 * c.I1 * 8 + 2 * c.Jt * 4)
                del copy, out, sk, tables
            self.ms = ms


def leaf_index(cfg, name):
    """Index of the reference leaf ``name`` in ``param_leaves`` order
    (the order depends on the config's structure alone, so a reduced copy
    on the CPU gives it)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import transformer as tf
    names = [n for n, _ in tf.param_leaves(
        tf.init_params(reduced_config(cfg.name), seed=0, device="cpu"))]
    return names.index(name)


def train_compressed(cfg, dev):
    """``COMPRESS_STEPS`` steps of ``cfg`` with FCS gradient compression
    through train/loop.py, checked and timed by ``CompressProbe``."""
    from repro_torch.train import grad_compress as gcm
    from repro_torch.train.loop import train
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, grad_compression=True))
    logs = []
    probe = CompressProbe(cfg, leaf_index(cfg, COMPRESS_LEAF))
    gcm.probe = probe.compressed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        hist = train(cfg, steps=COMPRESS_STEPS, batch=TRAIN["batch"],
                     seq=TRAIN["seq"], lr=TRAIN["lr"], seed=SEED, device=dev,
                     log_every=1, log_fn=logs.append, on_grads=probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gcm.probe = None
    peak = torch.cuda.max_memory_allocated()
    codecs = probe.codecs
    for ln in logs:
        print(f"[train] compressed: {ln}")
    if not all(np.isfinite(hist.losses)) or len(hist.losses) != \
            COMPRESS_STEPS or probe.counts != [len(codecs)] * COMPRESS_STEPS \
            or probe.report is None or probe.ms is None:
        fail(f"compressed train: losses {hist.losses}, leaves compressed a "
             f"step {probe.counts} (codecs {len(codecs)}), in-situ "
             f"{probe.report}")
    jt = sum(c.Jt for c in codecs)
    n = sum(c.I1 * c.k - c.pad for c in codecs)
    draw, sketch, est, old = probe.ms
    print(f"[train] compressed: yi-9b, {COMPRESS_STEPS} steps with FCS "
          f"gradient compression (ratio {cfg.sketch.grad_hash_ratio}) before "
          f"sketched AdamW: losses "
          + ", ".join(f"{x:.4f}" for x in hist.losses) + "; step ms "
          + ", ".join(f"{t * 1e3:.1f}" for t in hist.step_times)
          + f" ({wall:.2f}s incl. init); leaves compressed a step "
          f"{probe.counts} = the codecs' {len(codecs)}; {n} gradient "
          f"elements -> {jt} sketch floats a step ({4 * jt} B, what an "
          f"all-reduce would move; {2 * n} B of bf16 gradient); peak "
          f"allocated {peak} B ({peak / 2 ** 30:.2f} GiB; at each hook, "
          f"allocated / peak so far: "
          + ", ".join(f"{a} / {p}" for a, p in probe.mem) + f"); {card()}")
    print(f"[train] compressed: {probe.report}")
    print(f"[train] compressed: compression per step {draw + sketch + est:.3f}"
          f" ms on the device (hash draw {draw:.3f}, sketch (rows by "
          f"bucket, then columns) {sketch:.3f}, estimate gather {est:.3f}; "
          f"the element-by-element index_add_ sketch it replaced "
          f"{old:.3f}; step 1's gradient, copies leaf by leaf, CUDA "
          f"events); bound "
          f"{probe.bytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({probe.bytes} B: "
          f"g read and the estimate written, h1 / s1 and the sketch written "
          f"and read, once each); {card()}")
    return hist




# ---------------------------------------------------------------------------
# phase 6: moe, and the other attention configs, on the paged slot engine
# ---------------------------------------------------------------------------

# the moe family at full width, cut to MOE_LAYERS of its layers (granite
# 32, deepseek 28; 8 until PR 29's resume checks): each engine's eager
# twin launches every layer's kernels from the host, and the cut keeps
# the whole run well inside its time limit.  Phase train-families trains
# granite-moe at 8 layers.
MOE = ("granite-moe-3b-a800m", "deepseek-moe-16b")
MOE_LAYERS = 4
# the largest router-logit gap by which a routing decision of one path
# may trail the other path's own choice: a near-tie that rounding flips,
# not a wrong expert (full-width router logits spread about 1).  Measured
# (tools/moe_drift.py, PERF.md section 6): up to 0.0662 for the plain
# path on the kernel path's experts at deepseek-moe's 28 layers, 0.0428
# for granite's recompute on the served experts.  Two bf16 paths drift
# apart with depth even on one routing (deepseek-moe, kernel vs plain on
# the kernel's experts: 1.62 / 2.35 / 3.06% of max|logit| at 8 / 16 / 28
# layers), which the 3% logit check allows at MOE_LAYERS
NEAR_TIE = 0.1
# full width, depth cut to CUT_LAYERS layers (the kernels see every layer
# alike; the cut keeps the phase near two minutes)
CUT = ("minitron-4b", "qwen2.5-32b", "musicgen-medium", "internvl2-2b")
CUT_LAYERS = 2
# the serve phase's stream shape (3 shared 64-token prefixes), with
# shorter tails and outputs: each engine's eager twin launches every
# layer's kernels from the host, ~10x its graphed time
MOE_TAIL, MOE_NEW = 32, 8


def dropless(cfg):
    """``cfg`` with capacity_factor E / K, so C >= group_size: no choice
    is ever dropped."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def step_weight_bytes(cfg):
    """Weight bytes a decode step reads in its FFNs: every expert's GLU
    weights (the dispatch runs each expert's C rows, full or not) and the
    shared experts', or the dense GLU's."""
    if cfg.family != "moe":
        return cfg.num_layers * 3 * cfg.d_model * cfg.d_ff * 2
    m = cfg.moe
    return (cfg.num_layers * (m.num_experts + m.num_shared_experts) * 3
            * cfg.d_model * m.expert_d_ff * 2)


def parity_inputs(cfg, params, dev):
    """The inputs of ``logit_parity``: a paged cache of 8 slots (one
    idle; contexts of up to 63 tokens prefilled in 32-token chunks on the
    kernel path), a decode step's tokens and positions, and a 32-token
    chunk of new tokens into slot 1 at its last chunk's offset:
    {"cache", "tables", "cur", "pos", "chunk", "start"}."""
    from repro_torch.models import transformer as tf
    B, NB, bs, nbs = 8, 256, 16, 32
    rng = np.random.RandomState(SEED + 21)
    cache = tf.init_paged_cache(cfg, NB, bs, dev)
    tables = torch.full((B, nbs), NB, dtype=torch.int32, device=dev)
    lens = rng.randint(1, 64, B)
    lens[0] = 0
    nxt = 0
    for b in range(1, B):
        n = -(-(int(lens[b]) + 1) // bs)
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
    cur = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, 1)), device=dev)
    off = int(lens[1]) // 32 * 32
    chunk = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, 32)),
                            device=dev)
    start = torch.full((1,), off, dtype=torch.int32, device=dev)
    return dict(cache=cache, tables=tables, cur=cur, pos=pos, chunk=chunk,
                start=start)


def parity_logits(cfg, params, inp, kernels, blocks=None):
    """The decode step's logits of slots 1..7 and the chunk's, over the
    real vocab, on clones of ``inp``'s cache (``kernels`` as in
    ``tf.forward``; ``blocks``: the first that many layers only)."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    if blocks is not None:
        params = dict(params, blocks=params["blocks"][:blocks])
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    B = inp["cur"].shape[0]
    ld, _ = tf.decode_step(params, clone(inp["cache"]), inp["cur"],
                           inp["pos"], cfg, inp["tables"], kernels=kernels,
                           rows=ly.padded_rows(B))
    y, _ = tf.forward(params, tf.embed_inputs(params, inp["chunk"]), cfg,
                      mode="chunk", cache=clone(inp["cache"]),
                      index=inp["start"], tables=inp["tables"][1:2],
                      kernels=kernels)
    return (ld[1:, :cfg.vocab_size],
            ly.logits_fn(params, y, cfg)[0, :, :cfg.vocab_size])


def logit_parity(cfg, params, dev, what, flush, bad):
    """A decode step of 8 slots and a 32-token chunk's logits
    (``parity_inputs``), kernel path vs plain path on identical caches, the plain path forced
    onto the kernel path's experts (models/routing.py): within 3% of
    max|logit|, and greedy argmax equal where the plain path's margin
    exceeds twice that.  A failed check is appended to ``bad``."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import RoutingProbe
    inp = parity_inputs(cfg, params, dev)
    out = {}
    with RoutingProbe() as own:
        out[None] = parity_logits(cfg, params, inp, None)
    with RoutingProbe(own.forcing()) as routing:
        out[False] = parity_logits(cfg, params, inp, False)
    cache, tables, cur, pos = (inp[k] for k in ("cache", "tables", "cur",
                                                "pos"))
    B = cur.shape[0]
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    # where a decode step's time goes (kernel path, the engine's rows)
    c = clone(cache)
    busy, by_name, wall = device_ms(
        lambda: tf.decode_step(params, c, cur, pos, cfg, tables,
                               rows=ly.padded_rows(B)), 2, flush)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] {what} decode_step B=8 at {ly.padded_rows(B)} padded "
          f"rows: wall {wall:.3f} ms/step, device busy {busy:.3f} ms "
          f"({100 * (1 - busy / wall):.1f}% idle), {len(by_name)} kernel "
          f"names; top kernels "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    del c
    gaps = []
    if cfg.family == "moe":
        if routing.worst > NEAR_TIE:
            bad.append(f"{what}: the plain path's own routing differs from "
                       f"the kernel path's by {routing.worst} (> "
                       f"{NEAR_TIE})")
        gaps.append(f"plain path on the kernel path's experts: its own "
                    f"top-k differs in {routing.differ}/{routing.rows} "
                    f"routed rows, by at most {routing.worst:.3e} in router "
                    f"logits")
    for (lk, lp), name in zip(zip(out[None], out[False]), ("decode",
                                                            "chunk")):
        diff = (lk - lp).abs().max().item()
        tol = 0.03 * lp.abs().max().item()
        top2 = lp.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        if not torch.isfinite(lk).all() or diff > tol or not bool(
                (lk.argmax(-1) == lp.argmax(-1))[sure].all()):
            bad.append(f"{what}: {name} logits, kernel vs plain: max|dlogit| "
                       f"{diff} (tol {tol})")
        gaps.append(f"{name} max|dlogit| {diff:.4e} (tol {tol:.4e}, "
                    f"{100 * diff / lp.abs().max().item():.2f}% of "
                    f"max|logit|)")
    del cache, inp
    return "; ".join(gaps)


def phase_moe(dev):
    """The attention configs beyond gemma-2b on the paged slot engine,
    each graphed and as its eager twin (``twin_streams``).  granite-moe
    at full width, cut to MOE_LAYERS layers, serves the serve phase's
    stream; it provably
    drops nothing (a chunk of prefill_bucket rows or a decode step of
    max_batch rows puts at most that many choices on one expert, both <=
    C), so its greedy tokens are held to a teacher-forced recompute of a
    dropless copy.  deepseek-moe (C 20 < 32: chunk prefill may drop) at
    full width, cut to MOE_LAYERS layers, serves 8 requests; the four
    other configs at full width, cut to CUT_LAYERS layers, serve 4.  Each
    also holds a decode step's and a chunk's logits, kernel path vs plain
    path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_request_stream
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import RoutingProbe, ServedRouting
    from repro_torch.serve.frontend import AsyncServeEngine
    launches = 0
    bad = []                  # failed logit checks, reported at the end
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    for arch in MOE + CUT:
        t0 = time.perf_counter()
        layers = MOE_LAYERS if arch in MOE else CUT_LAYERS
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        cut = f", depth cut to {layers} layers"
        params = tf.init_params(cfg, seed=SEED, device=dev)
        secs = [time.perf_counter()]
        parity = logit_parity(cfg, params, dev, arch, flush, bad)
        secs.append(time.perf_counter())
        serve = dataclasses.replace(cfg.serve, **SERVE)
        n = {"granite-moe-3b-a800m": 16, "deepseek-moe-16b": 8}.get(arch, 4)
        reqs = make_request_stream(cfg, np.random.RandomState(SEED + 2), n,
                                   3, 64, MOE_TAIL, MOE_NEW,
                                   sampled_frac=0.25, temperature=0.8,
                                   top_k=8)
        served = []

        def make_front(graphs):
            if graphs is not False or cfg.family != "moe":
                return AsyncServeEngine(cfg, params, serve=serve,
                                        device=dev, graphs=graphs)
            # the eager twin (bitwise the graphed engine) records which
            # experts each request's rows chose; active once it is built
            served.append(ServedRouting(cfg.num_layers, serve.max_batch))
            front = AsyncServeEngine(cfg, params, serve=serve, device=dev,
                                     graphs=False, obs=served[0])
            served[0].__enter__()
            return front

        try:
            run = twin_streams(arch, make_front, reqs, dev)
        finally:
            for r in served:
                r.__exit__()
        secs.append(time.perf_counter())
        done, st = run["done"], run["stats"]
        ok = [c for c in done if c.status == "ok"
              and len(c.tokens) == MOE_NEW
              and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
        pa = run["launches"]["paged_attention"]
        # the count-min filter admits a prefix on its second sighting:
        # only granite's 16 requests are sure to hit
        if pa <= 0 or len(ok) != len(reqs) or (
                len(reqs) == 16 and st.prefix_hits <= 0):
            fail(f"{arch}: launches {pa}, completed ok {len(ok)}/"
                 f"{len(reqs)}, prefix hits {st.prefix_hits}")
        launches += pa
        oracle = ""
        if arch == "granite-moe-3b-a800m":
            C = moe.capacity(cfg)
            if max(serve.prefill_bucket, serve.max_batch) > C:
                fail(f"{arch}: a chunk of {serve.prefill_bucket} or a step "
                     f"of {serve.max_batch} rows may fill an expert's {C}")
            byrid = {r.rid: r for r in reqs}
            prompts = {r.rid: r.tokens for r in reqs}
            free = dropless(cfg)
            exact = total = differ = rows = 0
            worst = tie = 0.0
            for c in [c for c in done if not byrid[c.rid].temperature][:3]:
                req = byrid[c.rid]
                toks = np.concatenate([req.tokens, c.tokens[:-1]])
                with RoutingProbe(served[0].forcing_of(
                        toks, c.rid, prompts, free, dev)) as r:
                    short, tol, n_top1 = greedy_shortfall(
                        params, free, dev, req.tokens, c.tokens)
                if short > tol:
                    fail(f"{arch}: rid {c.rid} served a token {short} below "
                         f"the dropless recompute's top-1 (tol {tol})")
                if r.worst > NEAR_TIE:
                    fail(f"{arch}: rid {c.rid}: the recompute's own routing "
                         f"differs from the served experts by {r.worst} in "
                         f"router logits "
                         f"(> {NEAR_TIE})")
                worst = max(worst, short / tol)
                tie = max(tie, r.worst)
                differ += r.differ
                rows += r.rows
                exact += n_top1
                total += len(c.tokens)
            oracle = (f"; no drop possible (chunk {serve.prefill_bucket} and "
                      f"step {serve.max_batch} rows <= C {C}): greedy vs "
                      f"the dropless recompute (capacity_factor "
                      f"{free.moe.capacity_factor}, C "
                      f"{moe.capacity(free)}) on the served experts: "
                      f"{exact}/{total} its top-1, worst shortfall "
                      f"{worst:.2f} of tol; its own top-k differs from the "
                      f"served in {differ}/{rows} routed rows, by at most "
                      f"{tie:.3e} in router logits")
        elif cfg.family == "moe":
            oracle = f"; C {moe.capacity(cfg)}"
        secs.append(time.perf_counter())
        ntok = sum(len(c.tokens) for c in done)
        wb = step_weight_bytes(cfg)
        print(f"[moe] {arch} full width{cut}: {cfg.param_count()} params, "
              f"{len(reqs)} requests "
              f"({sum(1 for r in reqs if r.temperature)} sampled), graphed: "
              f"{ntok / run['wall']:.2f} tok/s, TTFT p50 "
              f"{np.percentile(run['ttfts'], 50) * 1e3:.2f} ms, decode chunk "
              f"{run['chunk']:.3f} ms ({serve.decode_chunk} steps), prefill "
              f"chunk p50 {np.percentile(run['prefill_ms'], 50):.3f} ms, "
              f"captures {run['caps'][0]} decode / {run['pcaps'][0]} "
              f"prefill, prefix hits {st.prefix_hits}/{st.prefix_lookups}, "
              f"paged_attention launches {pa}; FFN weights read per decode "
              f"step {wb} B (>= {wb / HBM_BYTES_PER_S * 1e3:.3f} ms at the "
              f"memory rate){oracle}; kernel vs plain: {parity}; "
              f"{time.perf_counter() - t0:.1f}s (init {secs[0] - t0:.1f}, "
              f"logits {secs[1] - secs[0]:.1f}, streams "
              f"{secs[2] - secs[1]:.1f}, oracle {secs[3] - secs[2]:.1f}); "
              f"{card()}")
        del run, params
        gc.collect()
        torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))
    return launches


# ---------------------------------------------------------------------------
# phase 6b, moe-spec: speculative decoding of the moe family and of
# attention biases
# ---------------------------------------------------------------------------

MOE_SPEC_K = 4
MOE_SPEC_RATIO = 4
MOE_SPEC_REQUESTS = 8
# granite's exact-draft engine (draft = the whole target) and deepseek's
# engines serve at this depth; granite's spec-vs-plain engines at
# MOE_SPEC_GRANITE_LAYERS, qwen2.5's at CUT_LAYERS
MOE_SPEC_LAYERS = 4
# granite's spec-vs-plain engines, cut from 32 layers (16 from PR 28, 8
# since PR 29's resume checks) to keep the whole run well inside its time
# limit on a slow host (their eager twins launch every layer from the
# host); a verify step's 40 rows fit C 40 at any depth, so the greedy
# tokens must equal the plain engine's all the same
MOE_SPEC_GRANITE_LAYERS = 8
SPEC_DRAFTS = {"truncated_depth1": dict(spec_k=MOE_SPEC_K, draft_depth=1),
               "cs_depth1_ratio4": dict(spec_k=MOE_SPEC_K, draft_depth=1,
                                        draft_sketch_ratio=MOE_SPEC_RATIO)}


def spec_engine(what, cfg, params, serve, reqs, dev, make_front=None):
    """One engine of phase moe-spec: its draft derived (timed, its kernel
    launches counted), then its stream graphed and as its eager twin
    (``twin_streams``; ``make_front(graphs, draft)`` builds the engine,
    an AsyncServeEngine by default).  Prints a [spec] and a [profile]
    line; returns (graphed run, draft, launches of SPEC_KERNELS)."""
    from repro_torch.models.draft import make_draft
    from repro_torch.serve.frontend import AsyncServeEngine
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft = make_draft(params, cfg, serve)
    torch.cuda.synchronize()
    derive_s = time.perf_counter() - t0
    mine = {k: counters[k].launches for k in SPEC_KERNELS}
    build = make_front or (lambda graphs, d: AsyncServeEngine(
        cfg, params, serve=serve, device=dev, draft=d, graphs=graphs))
    run = twin_streams(what, lambda graphs: build(graphs, draft), reqs, dev)
    mine = {k: mine[k] + run["launches"][k] for k in SPEC_KERNELS}
    st, done = run["stats"], run["done"]
    ok = [c for c in done if c.status == "ok" and len(c.tokens) == MOE_NEW
          and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
    if len(ok) != len(reqs) or run["leaked"]:
        fail(f"{what}: completed ok {len(ok)}/{len(reqs)}, leaked blocks "
             f"{run['leaked']}")
    twin = run["twin_stats"]
    spec = ("spec_rounds", "spec_proposed", "spec_accepted")
    if [getattr(st, f) for f in spec] != [getattr(twin, f) for f in spec]:
        fail(f"{what}: speculative counters differ from the eager twin's")
    ntok = sum(len(c.tokens) for c in done)
    acc = (f"acceptance {st.acceptance_rate:.4f} ({st.spec_accepted}/"
           f"{st.spec_proposed}), mean accepted run "
           f"{st.mean_accepted_run:.4f} over {st.spec_rounds} rounds; draft "
           f"{draft.cfg.num_layers} layers (sketched head "
           f"{draft.cfg.sketch.sketched_head}) derived in {derive_s:.3f}s"
           if draft is not None else "plain")
    print(f"[spec] {what} (graphed): {ntok} tokens in {run['wall']:.4f}s = "
          f"{ntok / run['wall']:.2f} tok/s, TTFT p50 "
          f"{np.percentile(run['ttfts'], 50) * 1e3:.2f} ms; {acc}; "
          f"decode captures {run['caps'][0]}, none on the second pass; "
          f"speculative counters equal the eager twin's; leaked blocks 0; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in mine.items())
          + f"; {card()}")
    print(f"[profile] {what}: decode chunk {run['chunk']:.3f} ms (mean of "
          f"{run['chunks']} chunks of {serve.decode_chunk} "
          f"{'rounds' if draft else 'steps'}), busy per decode "
          f"{'round' if draft else 'step'} {run['busy_step']:.4f} ms (wall "
          f"{run['wall_step']:.4f} ms), stream idle "
          f"{100 * run['idle']:.1f}% (second pass, profiled), prefill chunk "
          f"p50 {np.percentile(run['prefill_ms'], 50):.3f} ms; {card()}")
    return run, draft, mine


def plain_engine(what, cfg, params, serve, reqs, dev, graphs=None,
                 obs=None):
    """A plain engine's reference tokens for phase moe-spec's spec
    engines: ``reqs`` through it twice graphed (the second pass
    profiled), or once eagerly (``graphs=False``, profiled; ``obs`` its
    observer).  Phase moe holds these configs' graphed plain engines
    bitwise to their eager twins.  Prints [spec] and [profile] lines;
    returns {rid: tokens} of the first pass."""
    from repro_torch.serve.frontend import AsyncServeEngine
    front = AsyncServeEngine(cfg, params, serve=serve, device=dev,
                             graphs=graphs, obs=obs)
    sched = front.scheduler
    passes = [drive_stream(front, with_generators(reqs, dev), last)
              for last in ((True,) if graphs is False else (False, True))]
    done, ttfts, wall, _ = passes[0]
    busy, pwall = passes[-1][3], passes[-1][2]
    leaked = leaked_blocks(sched)
    if leaked or len(done) != len(reqs):
        fail(f"{what}: completed {len(done)}/{len(reqs)}, leaked blocks "
             f"{leaked}")
    ntok = sum(len(c.tokens) for c in done)
    print(f"[spec] {what} ({'eager' if graphs is False else 'graphed'}): "
          f"{ntok} tokens in {wall:.4f}s = {ntok / wall:.2f} tok/s, TTFT "
          f"p50 {np.percentile(ttfts, 50) * 1e3:.2f} ms; plain; decode "
          f"captures {sched.decode_compilations}; leaked blocks 0; {card()}")
    print(f"[profile] {what}: decode chunk {np.mean(sched.chunk_ms):.3f} ms "
          f"(mean of {len(sched.chunk_ms)} chunks of {serve.decode_chunk} "
          f"steps), stream idle {100 * (1 - busy / pwall):.1f}% (the "
          f"profiled pass), prefill chunk p50 "
          f"{np.percentile(sched.prefill_chunk_ms(), 50):.3f} ms; {card()}")
    return {c.rid: c.tokens for c in done}


def greedy_apart(reqs, plain, got, upto=None):
    """Greedy requests whose tokens differ from ``plain``'s (each
    compared below ``upto[rid]`` tokens when given) and the number of
    tokens compared."""
    bad, n = [], 0
    for r in reqs:
        if r.temperature:
            continue
        k = len(plain[r.rid]) if upto is None else max(0, upto[r.rid])
        n += min(k, len(plain[r.rid]))
        if not np.array_equal(got[r.rid][:k], plain[r.rid][:k]):
            bad.append(r.rid)
    return bad, n


def first_drops(served, reqs):
    """Per request, the index of the first token that a dropped choice
    could have touched: the first row of its served by a decode or
    verify step (recorded by ``served``, a ``ServedRouting``) that lost
    a choice to capacity, less the prompt's last position; and the
    steps' (calls, calls with a drop, dropped choices)."""
    first = {r.rid: MOE_NEW for r in reqs}
    S = {r.rid: len(r.tokens) for r in reqs}
    calls = dropping = dropped = 0
    for c, cx in served.contexts():
        if cx is None or cx[0] != "decode":
            continue
        K = c.topi.shape[-1]
        keep = c.keep.reshape(-1, K).all(-1).cpu().numpy()
        calls += 1
        dropping += int(not keep.all())
        dropped += int((~c.keep).sum())
        for s in np.flatnonzero(~keep):
            rid, p = cx[1][s]
            if rid in first:
                first[rid] = min(first[rid], p - (S[rid] - 1))
    return first, calls, dropping, dropped


def prefill_apart(a, b, reqs, L, bucket):
    """Requests whose prompt rows a prefill chunk routed or dropped apart
    in two engines (``a``, ``b``: ``ServedRouting``s of their eager
    twins), below the last layer (whose KV precedes its FFN): chunks are
    matched by the prompt tokens they hold and their offset, so a prefix
    hit is held to the chunk that computed the rows it reads; a chunk one
    engine never ran counts as apart."""
    toks = {r.rid: r.tokens for r in reqs}

    def keeps(served):
        out = {}
        for c, cx in served.contexts():
            if cx is None or cx[0] != "prefill" or cx[1] not in toks \
                    or c.layer >= L - 1:
                continue
            _, rid, off = cx
            n = min(len(toks[rid]), off + bucket) - off
            K = c.topi.shape[-1]
            out.setdefault((tuple(toks[rid][:off + n]), off, c.layer), (
                c.topi.reshape(-1, K)[:n].cpu().numpy(),
                c.keep.reshape(-1, K)[:n].cpu().numpy()))
        return out

    ka, kb = keeps(a), keeps(b)
    apart = []
    for r in reqs:
        S = len(r.tokens)
        keys = [(tuple(r.tokens[:min(S, off + bucket)]), off, l)
                for off in range(0, S, bucket) for l in range(L - 1)]
        if any(k not in ka or k not in kb
               or not all(np.array_equal(x, y) for x, y in zip(ka[k], kb[k]))
               for k in keys):
            apart.append(r.rid)
    return apart


def phase_moe_spec(dev):
    """Speculative decoding of the moe family and of attention biases,
    every spec engine graphed and as its eager twin (``spec_engine``),
    each against a plain engine run once (``plain_engine``).

    granite-moe-3b-a800m at full width, MOE_SPEC_GRANITE_LAYERS layers: a
    plain engine, a
    truncated depth-1 draft and that draft compressed at ratio 4, spec_k
    4, on 8 requests of phase moe's stream shape.  A verify step routes
    8 x 5 = 40 rows, within C = 40, so nothing can drop and every greedy
    token must equal the plain engine's.  Then at MOE_SPEC_LAYERS layers
    an exact draft (the whole target, uncompressed) at spec_k 2, whose
    proposals are accepted (acceptance must be > 0).

    deepseek-moe-16b at full width, MOE_SPEC_LAYERS of 28 layers: plain
    and the compressed draft at spec_k 4.  Its C is 20 and a verify step
    routes 40 rows, so choices can drop; and a 32-row prefill chunk can
    drop too, its token-0 pad rows taking capacity: in the spec engine
    the pad rows past the request's rows attend the slot's speculative
    overhang block, in the plain engine they land in the write sink, so
    they route, and take capacity, differently.  The eager twins record
    the routing (``ServedRouting``) and each greedy request is held
    bitwise to the plain engine before its first verify row that lost a
    choice, and from the start only where every prefill chunk it reads
    routed and dropped alike in both engines (``prefill_apart``).

    qwen2.5-32b at full width, CUT_LAYERS layers, its attention biases
    drawn at random: plain, truncated and compressed drafts at spec_k 4,
    greedy bitwise plain; the draft's biases are the target's layer-0
    tensors."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_request_stream
    from repro_torch.models import layers as ly
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import ServedRouting
    from repro_torch.serve.frontend import AsyncServeEngine
    launches = {k: 0 for k in SPEC_KERNELS}

    def stream(cfg):
        return make_request_stream(cfg, np.random.RandomState(SEED + 2),
                                   MOE_SPEC_REQUESTS, 3, 64, MOE_TAIL,
                                   MOE_NEW, sampled_frac=0.25,
                                   temperature=0.8, top_k=8)

    def engines(arch, cfg, params, drafts):
        """A plain engine and one spec engine per ``drafts`` entry on
        ``stream(cfg)``: (requests, {name: run, or (run, draft)})."""
        serve = dataclasses.replace(cfg.serve, **SERVE)
        reqs = stream(cfg)
        out = {"plain": plain_engine(f"moe-spec {arch} plain", cfg, params,
                                     serve, reqs, dev)}
        for name, kw in drafts.items():
            run, draft, mine = spec_engine(
                f"moe-spec {arch} {name}", cfg, params,
                dataclasses.replace(serve, **kw), reqs, dev)
            for k in SPEC_KERNELS:
                launches[k] += mine[k]
            out[name] = (run, draft)
        return reqs, out

    def tokens(run):
        return {c.rid: c.tokens for c in run["done"]}

    # granite-moe at full width, cut in depth
    t0 = time.perf_counter()
    arch = "granite-moe-3b-a800m"
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=MOE_SPEC_GRANITE_LAYERS)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    C = moe.capacity(cfg)
    if SERVE["max_batch"] * (MOE_SPEC_K + 1) > C:
        fail(f"{arch}: a verify step's {SERVE['max_batch']} x "
             f"{MOE_SPEC_K + 1} rows may fill an expert's {C}")
    reqs, runs = engines(arch, cfg, params, SPEC_DRAFTS)
    plain = runs["plain"]
    for name in SPEC_DRAFTS:
        bad, n = greedy_apart(reqs, plain, tokens(runs[name][0]))
        if bad:
            fail(f"moe-spec {arch} {name}: greedy requests {bad} differ "
                 f"from the plain engine's tokens")
        if runs[name][0]["stats"].spec_rounds <= 0:
            fail(f"moe-spec {arch} {name}: no speculative round")
    print(f"[moe-spec] {arch} full width, {cfg.num_layers} of 32 "
          f"layers: {n} greedy tokens of both spec engines bitwise the "
          f"plain engine's (verify rows {SERVE['max_batch']} x "
          f"{MOE_SPEC_K + 1} <= C {C}: no drop possible); "
          f"{time.perf_counter() - t0:.1f}s; {card()}")
    del runs
    # the exact draft at MOE_SPEC_LAYERS layers: the draft is the target
    t0 = time.perf_counter()
    cut, cparams = cut_depth(cfg, params, MOE_SPEC_LAYERS)
    sv = dataclasses.replace(cut.serve, **SERVE, spec_k=2,
                             draft_depth=MOE_SPEC_LAYERS)
    run, draft, mine = spec_engine(
        f"moe-spec {arch} exact_depth{MOE_SPEC_LAYERS}_k2", cut, cparams,
        sv, stream(cut), dev)
    for k in SPEC_KERNELS:
        launches[k] += mine[k]
    if draft.cfg.num_layers != MOE_SPEC_LAYERS or \
            run["stats"].spec_accepted <= 0:
        fail(f"moe-spec {arch} exact draft: {draft.cfg.num_layers} layers, "
             f"{run['stats'].spec_accepted} proposals accepted")
    print(f"[moe-spec] {arch} exact draft ({MOE_SPEC_LAYERS} layers, the "
          f"whole target) at spec_k 2: acceptance "
          f"{run['stats'].acceptance_rate:.4f} > 0, graphed bitwise its "
          f"eager twin; {time.perf_counter() - t0:.1f}s")
    del run, draft, params, cparams
    gc.collect()
    torch.cuda.empty_cache()

    # deepseek-moe: drops are possible in a verify step and in a prefill
    # chunk, whose pad rows attend the spec engine's overhang block where
    # the plain engine's land in the write sink (the reference's books)
    t0 = time.perf_counter()
    arch = "deepseek-moe-16b"
    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_SPEC_LAYERS)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    serve = dataclasses.replace(cfg.serve, **SERVE)
    reqs = stream(cfg)
    served = {}

    def observed(name, sv):
        """A spec engine whose eager twin records its routing in
        ``served[name]`` (active once the twin is built)."""
        def make(graphs, draft):
            if graphs is not False:
                return AsyncServeEngine(cfg, params, serve=sv, device=dev,
                                        draft=draft, graphs=graphs)
            served[name] = ServedRouting(cfg.num_layers, SERVE["max_batch"],
                                         draft.cfg.num_layers)
            front = AsyncServeEngine(cfg, params, serve=sv, device=dev,
                                     draft=draft, graphs=False,
                                     obs=served[name])
            served[name].__enter__()
            return front
        return make

    sv = dataclasses.replace(serve, **SPEC_DRAFTS["cs_depth1_ratio4"])
    served["plain"] = ServedRouting(cfg.num_layers, SERVE["max_batch"])
    with served["plain"]:
        plain = plain_engine(f"moe-spec {arch} plain", cfg, params, serve,
                             reqs, dev, graphs=False, obs=served["plain"])
    try:
        run, _, mine = spec_engine(f"moe-spec {arch} cs_depth1_ratio4", cfg,
                                   params, sv, reqs, dev,
                                   observed("cs_depth1_ratio4", sv))
    finally:
        if "cs_depth1_ratio4" in served:
            served["cs_depth1_ratio4"].__exit__()
    for k in SPEC_KERNELS:
        launches[k] += mine[k]
    first, calls, dropping, dropped = first_drops(
        served["cs_depth1_ratio4"], reqs)
    apart = prefill_apart(served["plain"], served["cs_depth1_ratio4"], reqs,
                          cfg.num_layers, SERVE["prefill_bucket"])
    for rid in apart:
        first[rid] = 0
    bad, n = greedy_apart(reqs, plain, tokens(run), first)
    if bad:
        fail(f"moe-spec {arch}: greedy requests {bad} differ from the plain "
             f"engine's before their first dropped choice")
    cut_at = {rid: k for rid, k in first.items()
              if k < MOE_NEW and rid not in apart}
    print(f"[moe-spec] {arch} full width, {MOE_SPEC_LAYERS} of 28 layers, C "
          f"{moe.capacity(cfg)}: verify steps {calls} (recorded by the eager "
          f"twin over both passes and the window), {dropping} with a "
          f"dropped choice, {dropped} choices dropped; requests cut short "
          f"by a verify drop {cut_at or 'none'}; requests whose prompt rows "
          f"a prefill chunk routed or dropped apart in the two engines "
          f"(its pad rows attend another block) {apart or 'none'}; {n} "
          f"greedy tokens bitwise the plain engine's before each request's "
          f"first drop; {time.perf_counter() - t0:.1f}s; {card()}")
    del run, params, served
    gc.collect()
    torch.cuda.empty_cache()

    # qwen2.5: attention biases
    t0 = time.perf_counter()
    arch = "qwen2.5-32b"
    cfg = dataclasses.replace(get_config(arch), num_layers=CUT_LAYERS)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    g = torch.Generator(dev).manual_seed(SEED + 31)
    for blk in params["blocks"]:
        for k in ("bq", "bk", "bv"):
            blk["attn"][k] = (0.5 * torch.randn(
                blk["attn"][k].shape, generator=g, device=dev)).to(ly.PDTYPE)
    reqs, runs = engines(arch, cfg, params, SPEC_DRAFTS)
    plain = runs["plain"]
    for name in SPEC_DRAFTS:
        run, draft = runs[name]
        bad, n = greedy_apart(reqs, plain, tokens(run))
        d0, t0b = draft.params["blocks"][0]["attn"], \
            params["blocks"][0]["attn"]
        same = all(d0[k] is t0b[k] for k in ("bq", "bk", "bv"))
        if bad or not same:
            fail(f"moe-spec {arch} {name}: greedy requests {bad} differ from "
                 f"the plain engine's; draft biases the target's: {same}")
    print(f"[moe-spec] {arch} full width, {CUT_LAYERS} layers, random "
          f"attention biases: {n} greedy tokens of both spec engines bitwise "
          f"the plain engine's; the drafts' bq / bk / bv are the target's "
          f"layer-0 tensors; {time.perf_counter() - t0:.1f}s; {card()}")
    del runs, params
    gc.collect()
    torch.cuda.empty_cache()
    if min(launches.values()) <= 0:
        fail(f"moe-spec: launches on the path {launches}")
    print(f"[moe-spec] launches on the moe-spec path (the spec engines, "
          f"draft derivation included): {launches}; {card()}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the recurrent families on the slot engine
# ---------------------------------------------------------------------------

RECURRENT = ("xlstm-1.3b", "zamba2-2.7b")
# prompt lengths of the recurrent stream (shuffled by the seed): the
# conv-stash edges 1-4 (a 1-token prompt prefills nothing and zeroes its
# slot), then up to 448, which with 32 new tokens fills max_seq 512
REC_PROMPTS = (1, 2, 3, 4, 7, 16, 31, 64, 96, 128, 192, 256, 300, 352, 400,
               448)
REC_NEW = 32
# the lengths S at which REC_GAP_STEPS teacher-forced decode_steps after
# a prefill of S tokens (S = 0: from a zero state) are held to the
# forward (eager steps: ~0.1 s each at full width)
REC_CHECK_LENS = (0, 7, 63, 447)
REC_GAP_STEPS = 8
# How far the served (decode) form may sit from the full-sequence forward,
# % of the forward's max|logit|, over REC_NEW tokens (which bounds the
# gap over the first REC_GAP_STEPS).  Measured by
# tools/recurrent_drift.py at these lengths on an H100 (PERF.md section
# 6, run BS): in f32 the two forms agree within 0.534% (xlstm-1.3b) and
# 0.0014% (zamba2-2.7b); in bf16 zamba2's sit 3.1-5.4% apart at the first
# token and 8.3% over 32, while xlstm-1.3b's random-init bf16 logits move
# by 66-106% of max|logit| from f32 (and between the forms): its mLSTM
# normaliser max(|q.n|, exp(-m)) divides by near-cancelling sums, so a
# rounding difference flips whole rows.  A bf16 recompute therefore
# cannot tell a right xlstm token from a wrong one; its serve path is
# held to an f32 recompute through an f32 engine (same code, f32 weights
# and state), and the bf16 engine to its eager twin bitwise.  Each
# tolerance is about three times the largest reading, rounded up.
REC_TOL_F32 = 1.5
REC_TOL_BF16 = {"xlstm-1.3b": None, "zamba2-2.7b": 25.0}
# the phase serves each config at full width cut in depth: xlstm-1.3b
# to one of its layer groups of 7 mLSTM + 1 sLSTM blocks (8 of 48
# layers; two groups until PR 29's resume checks), zamba2-2.7b to two of
# its groups of 6 Mamba-2 blocks and a shared block, alternating between
# its two (12 of 54).  The eager twins and the eager sLSTM prefill launch
# every layer's kernels from the host; the cut keeps the whole run well
# inside its time limit.  Phase train-families trains both deeper.
REC_LAYERS = {"xlstm-1.3b": 8, "zamba2-2.7b": 12}


def recurrent_stream(cfg):
    """The phase's 16 requests: REC_PROMPTS in a seeded order, REC_NEW new
    tokens each, every fourth sampled (temperature 0.8, top-k 8)."""
    from repro_torch.serve.scheduler import Request
    rng = np.random.RandomState(SEED + 41)
    lens = rng.permutation(REC_PROMPTS)
    reqs = []
    for i, n in enumerate(lens):
        sampled = i % 4 == 3
        reqs.append(Request(
            rid=i, tokens=rng.randint(0, cfg.vocab_size, int(n)).astype(
                np.int32), max_new=REC_NEW,
            temperature=0.8 if sampled else 0.0, top_k=8 if sampled else 0,
            seed=int(rng.randint(1 << 30)) if sampled else None))
    return reqs


def bits(t):
    """``t``'s bits as integers, so a bitwise comparison treats NaN like
    any other pattern (an idle slot decodes junk state)."""
    return t.view({4: torch.int32, 2: torch.int16, 8: torch.int64,
                   1: torch.uint8}[t.element_size()])


def states_equal(a, b):
    from repro_torch.models import transformer as tf
    same = []
    tf.tree_map(lambda x, y: same.append(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))), a, b)
    return all(same)


def run_recurrent(front, reqs, dev, profiled):
    """A recurrent engine through the phase's stream with fresh caller
    generators: the first pass timed; with ``profiled`` (the graphed
    engine) a second pass under the CUDA-only profiler and a decode
    window (``decode_window``: max_batch requests admitted, then profiled
    rounds).  What the graphed engine and its eager twin are held equal
    on is taken after the first pass."""
    sched = front.scheduler
    log = chunk_log(sched)
    first = with_generators(reqs, dev)
    gens = [r.generator for r in first if r.generator is not None]
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    done, ttfts, wall, _ = drive_stream(front, first, False)
    torch.cuda.synchronize()
    out = dict(
        sched=sched, done=done, ttfts=ttfts, wall=wall,
        peak=torch.cuda.max_memory_allocated(), stats=sched.stats(),
        chunk=float(np.mean(sched.chunk_ms)), chunks=len(sched.chunk_ms),
        prefill_ms=sched.prefill_chunk_ms(),
        caps=[sched.decode_compilations],
        pcaps=[sched.prefill_compilations], log=list(log),
        tokens={c.rid: c.tokens for c in done},
        order=[c.rid for c in sched.completed],
        gens=[t.get_state() for t in gens],
        state=_clone_tree(sched._state.cache))
    if profiled:
        second = with_generators(reqs, dev)
        _, _, twall, busy = drive_stream(front, second, True)
        out["caps"].append(sched.decode_compilations)
        out["pcaps"].append(sched.prefill_compilations)
        window = with_generators([dataclasses.replace(r, rid=r.rid + 10_000)
                                  for r in reqs], dev)
        out["busy_step"], out["wall_step"], _ = decode_window(sched, window)
        out["idle"] = 1 - busy / twall
        out["caps"].append(sched.decode_compilations)
    torch.cuda.synchronize()
    g = sched._graphs
    out.update(used=0 if g is None else len(g.replays),
               variants=[] if g is None else g.variants(),
               pool=0 if g is None else g.pool_bytes(),
               launches={k: c.launches for k, c in counters.items()})
    return out


def recurrent_differences(g, e):
    """What differs between the graphed and the eager engine's first pass
    of one stream: tokens, completion order, every chunk's emit flags and
    the tokens they flag, every slot state leaf at the end (bitwise; every
    slot has held a request by then, so neither the graphed engine's
    warm-up nor an idle slot's junk can differ), the callers' generator
    states."""
    bad = []
    if g["order"] != e["order"]:
        bad.append("completion order")
    a, b = g["tokens"], e["tokens"]
    if a.keys() != b.keys() or any(not np.array_equal(a[r], b[r])
                                   for r in a):
        bad.append("tokens")
    if not flags_equal(g["log"], e["log"]):
        bad.append("emit flags or flagged tokens")
    if not states_equal(g["state"], e["state"]):
        bad.append("slot state at the end")
    if not gens_equal(g["gens"], e["gens"]):
        bad.append("callers' generator states")
    return bad


def decode_vs_forward(params, cfg, seq, S, dtype):
    """The recurrent families' two forms over seq's tokens S, S + 1, ...:
    (the full-sequence forward's logits at those positions, teacher-forced
    ``decode_step``s' from a ``prefill`` of the first S tokens, or from a
    zero state when S = 0), each (B, T, V) over the real vocab, f32.
    ``dtype``: the slot state's."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    B, T = seq.shape[0], seq.shape[1] - S
    with torch.no_grad():
        y, _ = tf.forward(params, tf.embed_inputs(params, seq), cfg)
        fwd = ly.logits_fn(params, y[:, S:], cfg)
        cache = tf.init_cache(cfg, B, S + T, seq.device, dtype)
        if S > 0:
            _, pre = tf.prefill(params, seq[:, :S], cfg)
            tf.tree_map(lambda dst, src: dst[:, :, :src.shape[2]].copy_(src),
                        cache, pre)
        dec = []
        for t in range(S, S + T):
            index = torch.full((B,), t, dtype=torch.int32, device=seq.device)
            lg, _ = tf.decode_step(params, cache, seq[:, t:t + 1], index, cfg)
            dec.append(lg)
    V = cfg.vocab_size
    return fwd[..., :V].float(), torch.stack(dec, 1)[..., :V].float()


def form_gaps(params, cfg, dev, dtype, tol_pct, what):
    """decode_vs_forward over REC_GAP_STEPS tokens at each REC_CHECK_LENS
    S, four sequences each: the gap as % of the forward's max|logit|,
    failing past ``tol_pct`` (None: reported only).  Returns a
    summary."""
    rng = np.random.RandomState(SEED + 31)
    gaps = []
    for S in REC_CHECK_LENS:
        seq = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                          (4, S + REC_GAP_STEPS)), device=dev)
        fwd, dec = decode_vs_forward(params, cfg, seq, S, dtype)
        gap = 100 * (dec - fwd).abs().max().item() / fwd.abs().max().item()
        if not torch.isfinite(dec).all() or (tol_pct is not None
                                             and gap > tol_pct):
            fail(f"{cfg.name}: {what} decode_steps after a prefill of {S} "
                 f"tokens sit {gap:.4f}% of max|logit| from the forward "
                 f"(tol {tol_pct}%)")
        gaps.append(f"S {S} {gap:.4f}%")
    return ", ".join(gaps)


def recurrent_recompute(params, cfg, dev, reqs, done, tol_pct):
    """Every served greedy token against the port's own full-sequence
    forward over the served context (prompt and tokens so far, one padded
    batch; trailing pad cannot reach earlier positions): its logit may
    fall at most ``tol_pct`` % of the row's max|logit| below the
    recompute's top-1 (a tie within tolerance passes; None: reported
    only).  Returns (top-1 agreements, tokens, worst shortfall in % of
    max|logit|)."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    byrid = {r.rid: r for r in reqs}
    greedy = [c for c in done if not byrid[c.rid].temperature]
    seqs = [np.concatenate([byrid[c.rid].tokens, c.tokens[:-1]])
            for c in greedy]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = q
    with torch.no_grad():
        y, _ = tf.forward(params, tf.embed_inputs(
            params, torch.as_tensor(batch, device=dev)), cfg)
    exact = total = 0
    worst = 0.0
    for i, c in enumerate(greedy):
        S = len(byrid[c.rid].tokens)
        with torch.no_grad():
            lg = ly.logits_fn(params, y[i:i + 1, S - 1:S - 1 + len(c.tokens)],
                              cfg)[0, :, :cfg.vocab_size].float()
        got = lg.gather(1, torch.as_tensor(c.tokens, device=dev).long()[
            :, None])[:, 0]
        short = 100 * (lg.max(-1).values - got).max().item() / \
            lg.abs().max().item()
        if tol_pct is not None and short > tol_pct:
            fail(f"{cfg.name}: rid {c.rid} (prompt {S}) served a token "
                 f"{short:.4f}% of max|logit| below the recompute's top-1 "
                 f"(tol {tol_pct}%)")
        worst = max(worst, short)
        exact += int((lg.argmax(-1).cpu().numpy() == c.tokens).sum())
        total += len(c.tokens)
    return exact, total, worst


def phase_recurrent(dev):
    """The recurrent families at full width and depth on the slot engine:
    a graphed engine (two passes and a decode window) and its eager twin
    (one pass), bitwise on the first pass (tokens, order, emit flags,
    slot state, generator states); one decode capture per variant used,
    none more after, no prefill capture; every request completes; none
    of the six kernels launches.  The serve path's function is held to
    the full-sequence forward in f32 (an f32 engine's greedy tokens, and
    decode after prefill, within REC_TOL_F32) and, where bf16 allows
    (REC_TOL_BF16), in bf16 too."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.frontend import AsyncServeEngine
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    for arch in RECURRENT:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=REC_LAYERS[arch])
        params = tf.init_params(cfg, seed=SEED, device=dev)
        serve = cfg.serve
        B = serve.max_batch
        reqs = recurrent_stream(cfg)
        secs = [time.perf_counter()]
        g = run_recurrent(AsyncServeEngine(cfg, params, serve=serve,
                                           device=dev), reqs, dev, True)
        e = run_recurrent(AsyncServeEngine(cfg, params, serve=serve,
                                           device=dev, graphs=False),
                          reqs, dev, False)
        secs.append(time.perf_counter())
        bad = recurrent_differences(g, e)
        if g["caps"] != [g["used"]] * 3 or not 1 <= g["used"] <= 2 \
                or e["caps"] != [0]:
            bad.append(f"decode captures {g['caps']} (eager {e['caps']}) "
                       f"for {g['used']} variants used")
        if g["pcaps"] != [0, 0] or e["pcaps"] != [0]:
            bad.append(f"prefill captures {g['pcaps']} / {e['pcaps']}")
        ok = [c for c in g["done"] if c.status == "ok"
              and len(c.tokens) == REC_NEW
              and ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()]
        if len(ok) != len(reqs):
            bad.append(f"completed ok {len(ok)}/{len(reqs)}")
        launched = {k: n for k, n in {**g["launches"],
                                      **e["launches"]}.items() if n}
        if launched:
            bad.append(f"kernels launched on a recurrent path: {launched}")
        sched = g["sched"]
        rows = tf.tree_map(lambda t: tuple(t.shape), sched._state.cache)
        padded = [t.shape for t in _leaves(sched._state.cache)
                  if t.shape[1] != B]
        if padded:
            bad.append(f"state leaves not of max_batch {B} rows: {padded}")
        if bad:
            fail(f"{arch}: the graphed engine differs from its eager twin "
                 f"or the stream failed: " + ", ".join(bad))
        state_bytes = sched.kv_cache_bytes()
        # the eager twin's figures, before it is freed
        e_tok_s = sum(len(c.tokens) for c in e["done"]) / e["wall"]
        e_ttft = np.percentile(e["ttfts"], 50) * 1e3
        e_chunk = e["chunk"]
        e_pf50 = np.percentile(e["prefill_ms"], 50)
        e_pfmax = max(e["prefill_ms"])
        tol16 = REC_TOL_BF16[arch]
        b16 = recurrent_recompute(params, cfg, dev, reqs, g["done"], tol16)
        gaps16 = ("not run (tools/recurrent_drift.py measures them)"
                  if tol16 is None else
                  form_gaps(params, cfg, dev, torch.bfloat16, tol16, "bf16"))
        rng = np.random.RandomState(SEED + 51)
        state = tf.init_cache(cfg, B, serve.max_seq, dev)
        cur = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, 1)),
                              device=dev)
        pos = torch.as_tensor(rng.randint(0, 400, B).astype(np.int32),
                              device=dev)
        busy, by_name, wall = device_ms(
            lambda: tf.decode_step(params, state, cur, pos, cfg), 3, flush)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        del g["sched"], e, sched, state
        gc.collect()
        torch.cuda.empty_cache()
        secs.append(time.perf_counter())
        # the same path in f32: an f32 engine (graphed) serves max_batch
        # of the greedy requests, one wave, held to the f32 forward
        p32 = tf.tree_map(lambda t: t.float(), params)
        del params
        greedy = [r for r in reqs if not r.temperature][:B]
        f = run_recurrent(AsyncServeEngine(cfg, p32, serve=serve,
                                           device=dev), greedy, dev, False)
        if f["caps"] != [1] or len(f["done"]) != len(greedy):
            fail(f"{arch}: f32 engine captures {f['caps']}, completed "
                 f"{len(f['done'])}/{len(greedy)}")
        b32 = recurrent_recompute(p32, cfg, dev, greedy, f["done"],
                                  REC_TOL_F32)
        gaps32 = form_gaps(p32, cfg, dev, torch.float32, REC_TOL_F32, "f32")
        del f, p32
        gc.collect()
        torch.cuda.empty_cache()
        secs.append(time.perf_counter())

        ntok = sum(len(c.tokens) for c in g["done"])
        tol_txt = ("reported only: bf16 cannot tell" if tol16 is None
                   else f"tol {tol16}%")
        print(f"[recurrent] {arch} full width, depth cut to "
              f"{cfg.num_layers} layers: "
              f"{cfg.param_count()} params, {len(reqs)} requests (prompts "
              f"{min(REC_PROMPTS)}-{max(REC_PROMPTS)}, "
              f"{sum(1 for r in reqs if r.temperature)} sampled, {REC_NEW} "
              f"new each), max_batch {B}, max_seq {serve.max_seq}, "
              f"decode_chunk {serve.decode_chunk}; graphed (eager twin): "
              f"{ntok / g['wall']:.2f} "
              f"({e_tok_s:.2f}) tok/s, "
              f"TTFT p50 {np.percentile(g['ttfts'], 50) * 1e3:.2f} "
              f"({e_ttft:.2f}) ms, decode chunk {g['chunk']:.3f} "
              f"({e_chunk:.3f}) ms (mean of {g['chunks']}), prefill ms p50 "
              f"{np.percentile(g['prefill_ms'], 50):.3f} ({e_pf50:.3f}), max "
              f"{max(g['prefill_ms']):.3f} ({e_pfmax:.3f}) "
              f"({len(g['prefill_ms'])} eager prefills of S - 1 tokens); "
              f"decode captures {g['caps']} after each pass and the window "
              f"({', '.join(v.name for v in g['variants'])}), prefill "
              f"captures 0, graphs' pool {g['pool']} B; slot state "
              f"{state_bytes} B, leaves {rows}; peak allocated {g['peak']} "
              f"B; bitwise equal, first pass: tokens of {len(g['order'])} "
              f"requests, emit flags of {len(g['log'])} chunks, completion "
              f"order, every state leaf, {len(g['gens'])} callers' "
              f"generator states; none of the six kernels launched; "
              f"{card()}")
        print(f"[recurrent] {arch} oracles: f32 engine's greedy tokens vs "
              f"the f32 recompute {b32[0]}/{b32[1]} its top-1, worst "
              f"shortfall {b32[2]:.4f}% of max|logit| (tol {REC_TOL_F32}%); "
              f"f32 decode after prefill vs forward over {REC_GAP_STEPS} "
              f"tokens: "
              f"{gaps32} (tol {REC_TOL_F32}%); bf16 engine's greedy tokens "
              f"vs the bf16 recompute {b16[0]}/{b16[1]} its top-1, worst "
              f"shortfall {b16[2]:.4f}% ({tol_txt}); bf16 decode after "
              f"prefill vs forward: {gaps16} ({tol_txt}); "
              f"{time.perf_counter() - t0:.1f}s (init {secs[0] - t0:.1f}, "
              f"streams {secs[1] - secs[0]:.1f}, bf16 checks "
              f"{secs[2] - secs[1]:.1f}, f32 engine and checks "
              f"{secs[3] - secs[2]:.1f}); {card()}")
        print(f"[profile] {arch}: graphed, busy per decode step "
              f"{g['busy_step']:.4f} ms (wall {g['wall_step']:.4f} ms, "
              f"window idle "
              f"{100 * (1 - g['busy_step'] / g['wall_step']):.1f}% over up "
              f"to {WINDOW_CHUNKS} chunks, {B} slots live), stream idle "
              f"{100 * g['idle']:.1f}% (second pass); one eager "
              f"decode_step of {B} slots, L2 flushed: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms; weights {wbytes} B + state "
              f"{state_bytes} B (>= "
              f"{(wbytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"to read both and write the state at the memory rate); top "
              f"kernels " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top)
              + f"; {card()}", flush=True)
        del g
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: train-families
# ---------------------------------------------------------------------------

# (config, layers kept or None for all, the sketched leaf checked in situ,
# the f32 directional-derivative check's eps or None for no check, the
# pieces its direction covers: None for all, else a test of (leaf, layer,
# layers)).  deepseek-moe-16b's
# 16.9 B params and their gradients do not fit one card: 4 of its 28
# layers; the others run cut, to keep the whole run well inside its
# time limit on a slow host (PERF.md section 4): granite-moe 8 of 32,
# xlstm-1.3b two of its six layer groups (16 of 48), musicgen-medium 24
# of 48, internvl2-2b 12 of 24, zamba2-2.7b three of its nine groups (18
# of 54; PR 28 ran granite 16, xlstm 24 and the other three whole, PR 29
# cut them for its resume checks).  The
# leaf is one that only the family has: an expert stack, the
# shared experts, the embedding table the frontend stubs' batches never
# read (a zero gradient), an mLSTM projection, a Mamba-2 projection
FAMILIES = (("granite-moe-3b-a800m", 8, "blocks/moe/we_gate", 1e-3, None),
            ("deepseek-moe-16b", 4, "blocks/moe/ws_gate", None, None),
            ("musicgen-medium", 24, "embed", None, None),
            ("internvl2-2b", 12, "embed", None, None),
            ("xlstm-1.3b", 16, "blocks/mlstm/out_proj", 1e-2,
             lambda name, i, n: name in ("head", "final_norm")
             or (name.startswith("blocks/slstm/") and i == n - 1)),
            ("zamba2-2.7b", 18, "blocks/mamba/wx", 1e-3, None))
FAM = dict(steps=3, batch=8, seq=128, lr=3e-4)
# the families whose crashed-and-resumed run is held bitwise (resume_check)
RESUME_FAMILIES = ("granite-moe-3b-a800m",)
# the directional check: d = N(0, 1) x (rms of each param piece + 1e-3),
# from a seeded generator; central differences at eps, 2 eps and 4 eps.
# eps is the config's: the recurrent gates bend the loss within 1e-2 of
# the relative scale (reduced configs on the CPU: zamba2's fd within 0.3%
# of <grad, d> at 1e-3, 42% off at 1e-2).  A random-init xLSTM's loss is
# rough wherever an mLSTM block lies downstream (its normaliser
# max(|q.n|, exp(-m)) divides by near 0): fd / <grad, d> swung 0.55-1.3
# over eps 1e-4 .. 3e-3 along the mLSTM weights in both packages, and at
# full width the three fd along every leaf but those disagreed in sign.
# So its d covers the last sLSTM layer (the whole time loop's backward),
# the final norm and the head, smooth to eps 1e-2 on the CPU (the three
# fd within 0.4% of one another); the other gradients are held to the
# reference's in f32 on the CPU (tests/test_torch_train_families.py)


def forward_ms(cfg, params, batch):
    """Device ms of one forward of ``loss_fn`` on ``batch`` under the
    CUDA profiler (without autograd: the same kernels; the backward's
    share is the profiled step's busy less its optimizer span and this,
    which spares profiling the backward's recomputes twice)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as pf:
        tf.loss_fn(params, batch, cfg)
        torch.cuda.synchronize()
    return sum(ns for _, _, ns in kernel_records(pf)) / 1e6


def directional_check(cfg, params, dev, eps, scope=None):
    """The f32 backward against central differences of the loss along a
    seeded random direction d (0 on the pieces ``scope`` rejects): fd(e) =
    (L(theta + e d) - L(theta - e d)) / 2e against <grad L, d>, at e =
    eps, 2 eps, 4 eps.  Tolerance, sized from eps: 1% of |<grad L, d>|,
    plus the spread of the three fd (the O(e^2) truncation grows 4x a
    doubling, so the spread bounds it at eps, and roughness of the loss
    shows in it), plus 16 ulp(L) / 2 eps (the f32 rounding of two loss
    evaluations).  For
    the moe family every evaluation runs on theta's routing (recorded,
    then forced through models/routing.py), on which the loss is smooth;
    the routing decisions that differ between theta +- eps d unforced are
    counted and reported.  ``params`` is an f32 copy on the card,
    perturbed in place and restored.  Returns the report line."""
    import contextlib
    from repro_torch.models import layers as ly
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import RoutingProbe
    from repro_torch.train import data as data_lib
    batch = data_lib.make_batch(cfg, 0, FAM["batch"], FAM["seq"], SEED, dev)
    pieces = [t for _, ps in tf.param_leaves(params) for t in ps]
    keep = [scope is None or scope(n, i, len(ps))
            for n, ps in tf.param_leaves(params) for i in range(len(ps))]
    scales = [(t.pow(2).mean().sqrt().item() + 1e-3) * k
              for t, k in zip(pieces, keep)]

    def directions():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 17)
        for t, sc in zip(pieces, scales):
            yield t, torch.randn(t.shape, generator=g, device=dev).mul_(sc)

    prev = ly.PDTYPE
    ly.PDTYPE = torch.float32
    try:
        forcing = None
        if cfg.family == "moe":
            with RoutingProbe() as rec, torch.no_grad():
                tf.loss_fn(params, batch, cfg)
            forcing = rec.forcing()

        def routed(n):
            if forcing is None:
                return contextlib.nullcontext()
            return RoutingProbe({k: v * n for k, v in forcing.items()})

        t0 = time.perf_counter()
        with routed(2):          # the forward and each block's recompute
            loss, grads = M.make_train_step(cfg)(params, batch)
        gpieces = [t for _, ps in tf.param_leaves(grads) for t in ps]
        dd = 0.0
        for (t, d), gr in zip(directions(), gpieces):
            dd += float(torch.sum(gr * d, dtype=torch.float64))
        del grads, gpieces
        flips = {}

        def loss_at(e):
            for t, d in directions():
                t.add_(d, alpha=e)
            try:
                with torch.no_grad():
                    if forcing is not None and abs(e) == eps:
                        with RoutingProbe() as own:
                            tf.loss_fn(params, batch, cfg)
                        flips[e] = sum(
                            int((c.topi.sort(-1).values
                                 != forcing[c.layer][0].sort(-1).values)
                                .any(-1).sum()) for c in own.calls)
                    with routed(1):
                        return float(tf.loss_fn(params, batch, cfg))
            finally:
                for t, d in directions():
                    t.sub_(d, alpha=e)

        L = {s * k * eps: loss_at(s * k * eps) for k in (1, 2, 4)
             for s in (1, -1)}
        secs = time.perf_counter() - t0
    finally:
        ly.PDTYPE = prev
    fd = [(L[k * eps] - L[-k * eps]) / (2 * k * eps) for k in (1, 2, 4)]
    fd1, spread = fd[0], max(fd) - min(fd)
    ulp = float(np.spacing(np.float32(abs(float(loss)))))
    tol = 0.01 * abs(dd) + spread + 16 * ulp / (2 * eps)
    err = abs(fd1 - dd)
    routing = ""
    if forcing is not None:
        rows = sum(int(v[0].shape[0] * v[0].shape[1])
                   for v in forcing.values())
        routing = (f"; routing decisions differing from theta's unforced: "
                   f"{flips[eps]} rows at +eps d, {flips[-eps]} at -eps d "
                   f"(of {rows} routed rows over the layers); the check runs "
                   f"on theta's routing, where none differ")
    if not (np.isfinite(dd) and err <= tol):
        fail(f"directional check {cfg.name}: fd {fd1} vs <grad, d> {dd} "
             f"(err {err}, tol {tol}){routing}")
    return (f"f32 directional check: L {float(loss):.6f}, <grad L, d> "
            f"{dd:.6e}, fd at eps {eps} / 2 eps / 4 eps "
            + " / ".join(f"{x:.6e}" for x in fd)
            + (f" (d on {sum(keep)} of {len(keep)} pieces)"
               if scope else "")
            + f"; |err| {err:.3e} <= tol {tol:.3e} (1% + spread "
            f"{spread:.3e} + 16 ulp(L) / 2 eps {16 * ulp / (2 * eps):.3e})"
            f"{routing}; {secs:.1f}s")


def phase_train_families(dev):
    """Every family through train/loop.py at full width, with sketched
    AdamW (ratio 4, rows 3): see the module docstring, phase 8.  Returns
    the sketch_update launches of the six runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.models import transformer as tf
    from repro_torch.train import data as data_lib
    from repro_torch.train.loop import train
    total = 0
    for arch, layers, leaf, eps, scope in FAMILIES:
        check = eps is not None
        t_cfg = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
            cfg.sketch, opt_state_ratio=4, opt_state_rows=3,
            opt_state_min_elems=1 << 16))
        out = {}

        def split(params, grads, opt, cfg=cfg, out=out):
            batch = data_lib.make_batch(cfg, FAM["steps"] - 1, FAM["batch"],
                                        FAM["seq"], SEED, dev)
            out["fwd"] = forward_ms(cfg, params, batch)

        def copy(params, grads, opt, out=out):
            # the seeded init: a few sketched-AdamW steps move coordinates
            # whose count-min v estimate is 0 by lr m_hat / eps (PERF.md)
            out["f32"] = tf.tree_map(
                lambda t: t.to(torch.float32, copy=True), params)

        hooks = {FAM["steps"] - 1: split}
        if check:
            hooks[0] = copy
        probe = TrainProbe(leaf=leaf, prof=1, lr=FAM["lr"], hooks=hooks)
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sketch_update.launches = 0
        hist = train(cfg, steps=FAM["steps"], batch=FAM["batch"],
                     seq=FAM["seq"], lr=FAM["lr"], seed=SEED, device=dev,
                     log_every=1, log_fn=logs.append, on_grads=probe)
        torch.cuda.synchronize()
        launches = sketch_update.launches
        total += launches
        peak = torch.cuda.max_memory_allocated()
        b = probe.moment_bytes
        if not all(np.isfinite(hist.losses)) or launches <= 0 \
                or probe.report is None or probe.breakdown is None \
                or "fwd" not in out:
            fail(f"train-families {arch}: losses {hist.losses}, "
                 f"sketch_update launches {launches}, in-situ "
                 f"{probe.report}")
        gc.collect()
        torch.cuda.empty_cache()
        line = ""
        if check:
            line = directional_check(cfg, out.pop("f32"), dev, eps, scope)
            gc.collect()
            torch.cuda.empty_cache()
        fwd = out["fwd"]
        bwd = probe.busy_ms - probe.opt_ms - fwd
        tokens = FAM["batch"] * FAM["seq"]
        print(f"[train-families] {arch} ({cfg.family}, {cfg.num_layers} "
              f"layers, {cfg.param_count()} params), batch {FAM['batch']} x "
              f"seq {FAM['seq']}, sketched AdamW ratio 4 rows 3: losses "
              + ", ".join(f"{x:.4f}" for x in hist.losses) + "; step ms "
              + ", ".join(f"{t * 1e3:.1f}" for t in hist.step_times)
              + " (step 0 copies the in-situ leaf"
              + (" and the params to f32" if check else "")
              + ", step 1 checks the leaf and the profiler runs from its "
              "optimizer to step 2's backward, step 2 profiles a forward"
              + f"); {tokens / probe.window_ms * 1e3:.1f} tokens/s over the "
              f"profiled step's wall {probe.window_ms:.3f} ms (device busy "
              f"{probe.busy_ms:.3f} ms); one step's device ms: forward "
              f"{fwd:.3f}, backward {bwd:.3f} (recomputes included: the "
              f"step's busy less its optimizer span and the forward), "
              f"sketch_update {probe.sketch_ms:.3f} (bound "
              f"{probe.bound[0]:.3f}); moments {b['sketched']} B sketched + "
              f"{b['dense']} B dense leaves (dense AdamW "
              f"{8 * cfg.param_count()} B); peak allocated {peak} B "
              f"({peak / 2 ** 30:.2f} GiB); sketch_update launches "
              f"{launches}; {time.perf_counter() - t_cfg:.1f}s; {card()}",
              flush=True)
        for ln in logs:
            print(f"[train-families] {arch}: {ln}")
        print(f"[train-families] {arch}: {probe.report}")
        print(f"[train-families] {arch}: {probe.breakdown}")
        if line:
            print(f"[train-families] {arch}: {line}", flush=True)
        del probe, hist, out
        gc.collect()
        torch.cuda.empty_cache()
        if arch in RESUME_FAMILIES:
            cut = dataclasses.replace(cfg, num_layers=RESUME["layers"])
            print(f"[train-families] {arch}: "
                  f"{resume_check(arch, cut, dev)}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return total


def _leaves(tree):
    from repro_torch.models import transformer as tf
    out = []
    tf.tree_map(out.append, tree)
    return out


def _clone_tree(tree):
    from repro_torch.models import transformer as tf
    return tf.tree_map(torch.clone, tree)


# ---------------------------------------------------------------------------
# Phase launch: the launch tooling on the card at a mesh of one
# ---------------------------------------------------------------------------

LAUNCH_LAYERS = 4          # of yi-9b's 48 (full width)
LAUNCH_SERVE_LAYERS = 2    # of gemma-2b's 18 (full width)
LAUNCH_DECODE_STEPS = 12
# the dry run's cells: phase train's yi-9b steps at batch B x 4096 at a
# (1, 1) mesh (read first, by train_4k), the card's yi-9b cut at a (1, 1)
# mesh, then three at the production mesh; (arch, shape, multi_pod, cut)
TRAIN_4K_CELLS = tuple(
    ("yi-9b", "train_4k", False,
     dict(batch=b, seq=TRAIN_4K["seq"], mesh_shape=(1, 1)))
    for b in TRAIN_4K["batches"])
DRYRUN_CELLS = TRAIN_4K_CELLS + (
    ("yi-9b", "train_4k", False,
     dict(layers=LAUNCH_LAYERS, batch=TRAIN["batch"], seq=TRAIN["seq"],
          mesh_shape=(1, 1))),
    ("yi-9b", "train_4k", False, {}),
    ("gemma-2b", "decode_32k", False, {}),
    ("deepseek-moe-16b", "train_4k", True, {}),
)
_DRYRUN = {}


_LAPS = []                 # (phase, perf_counter at its end), main's laps


def start_dryrun(root):
    """The dry run's cells in a CPU process of their own (meta tensors over
    a fake process group; no card), started at once so that they run
    while the card's phases do, at the lowest priority (nice 19) on one
    thread, so that the host-timed phases they overlap lose at most
    that; ``phase_launch`` collects them and names those phases."""
    import atexit
    code = ("import json, os, time\n"
            "os.nice(19)\n"
            "t0 = time.perf_counter()\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"for a, s, mp, cut in {DRYRUN_CELLS!r}:\n"
            "    c = run_cell(a, s, mp, **cut)\n"
            "    c.pop('traceback', None)\n"
            "    print(json.dumps(c), flush=True)\n"
            "print(json.dumps({'ran_s': time.perf_counter() - t0}))\n")
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    err = tempfile.TemporaryFile(mode="w+")     # its warnings, unread
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    _DRYRUN.update(proc=proc, err=err)
    _DRYRUN["t0"] = time.perf_counter()
    atexit.register(lambda: proc.poll() is None and proc.kill())


def collect_dryrun():
    proc = _DRYRUN["proc"]
    # read through the same buffered stream as walk_estimates: a
    # communicate() with a timeout reads the pipe's descriptor and would
    # miss lines that readline() has buffered
    out = proc.stdout.read()
    proc.wait(timeout=60)
    if proc.returncode != 0:
        _DRYRUN["err"].seek(0)
        fail(f"launch: the dry run exited {proc.returncode}: "
             f"{_DRYRUN['err'].read()[-3000:]}")
    lines = _DRYRUN.get("early", []) + [
        json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    cells = [c for c in lines if "arch" in c]
    bad = [c for c in cells if c.get("status") != "ok"]
    if len(cells) != len(DRYRUN_CELLS) or bad or "ran_s" not in lines[-1]:
        fail(f"launch: dry-run cells {[(c['arch'], c['shape'], c['status'], c.get('error')) for c in cells]}")
    return cells, lines[-1]["ran_s"]


def overlapped_phases(t0, ran_s):
    """The phases of ``_LAPS`` that ran while a process started at
    perf_counter ``t0`` ran for ``ran_s`` seconds."""
    names, start = [], _LAPS[0][1] if _LAPS else t0
    for what, end in _LAPS[1:]:
        if start < t0 + ran_s and end > t0:
            names.append(what)
        start = end
    return names


def local_tree(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t,
                    tree)


def same_bits(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
        y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


def bitwise(a, b):
    from repro_torch.models.transformer import param_leaves
    pa = [t for _, ps in param_leaves(a) for t in ps]
    pb = [t for _, ps in param_leaves(b) for t in ps]
    return len(pa) == len(pb) and all(same_bits(x, y)
                                      for x, y in zip(pa, pb))


LAUNCH_ADAMW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)


def adamw_agreement(p1, p0, st1, st0):
    """Two sketched-AdamW first steps from equal params and gradients: the
    same terms added in the same order, so every table and every param
    must be bitwise; the largest table difference relative to max|table|
    is reported beside the counts."""
    from repro_torch.models import transformer as tf
    from repro_torch.sketch.optimizer import SketchedMoments
    out = dict(tables_bits=True, tables_err=0.0, dense_bits=True,
               param_bits=0, pieces=0, sketched=0)
    for (_, p1s), (_, p0s), a, b in zip(tf.param_leaves(p1),
                                        tf.param_leaves(p0), st1.moments,
                                        st0.moments):
        if not isinstance(a, SketchedMoments):
            out["dense_bits"] &= all(same_bits(x, y)
                                     for x, y in zip(p1s, p0s))
            continue
        out["sketched"] += 1
        for x, y in ((a.m.table, b.m.table), (a.v.table, b.v.table)):
            out["tables_bits"] &= torch.equal(x, y)
            out["tables_err"] = max(out["tables_err"], float(
                (x - y).abs().max() / y.abs().max()))
        for x1, x0 in zip(p1s, p0s):
            out["param_bits"] += same_bits(x1, x0)
            out["pieces"] += 1
    return out


def launch_train(dev, mesh):
    """yi-9b at full width, ``LAUNCH_LAYERS`` layers, batch 8 x 128: the
    gradient step with FSDP placements on the (1, 1) mesh against the
    unsharded step, then sketched AdamW (ratio 4, rows 3) on each."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import logical_rules
    from repro_torch.sketch.optimizer import (sketched_adamw_init,
                                              sketched_adamw_update)
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=LAUNCH_LAYERS)
    B, S = TRAIN["batch"], TRAIN["seq"]
    rules, strategy = SH.make_rules(cfg, "train", False, False, B)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    pd = SH.distribute(params, SH.build_param_pspecs(cfg, params, rules,
                                                     strategy), mesh)
    del params
    gen = torch.Generator(dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :S].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    bd = SH.distribute(batch, {k: (rules["batch"], None) for k in batch},
                       mesh)
    step = M.make_train_step(cfg)
    gc.collect()
    torch.cuda.synchronize()
    card_args = sum(t.numel() * t.element_size() for t in
                    [t for _, ps in tf.param_leaves(local_tree(pd))
                     for t in ps] + list(batch.values()))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with logical_rules(rules), implicit_replication():
        loss1, grads1 = step(pd, bd)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    local = local_tree(pd)
    loss0, grads0 = step(local, batch)
    g1 = local_tree(grads1)
    if not (torch.equal(loss1.to_local(), loss0) and bitwise(g1, grads0)):
        fail(f"launch: the sharded step's loss {float(loss1.to_local())} "
             f"or gradients part from the unsharded step's {float(loss0)}")
    # sketched AdamW after each: the sharded step's DTensor params and an
    # unsharded copy of them
    ref_params = tf.tree_map(lambda t: t.clone(), local)
    sketch_update.launches = 0
    st1 = sketched_adamw_init(pd, 4, 3, 1 << 16)
    sketched_adamw_update(grads1, st1, pd, **LAUNCH_ADAMW)
    torch.cuda.synchronize()
    launches = sketch_update.launches
    st0 = sketched_adamw_init(ref_params, 4, 3, 1 << 16)
    sketched_adamw_update(grads0, st0, ref_params, **LAUNCH_ADAMW)
    torch.cuda.synchronize()
    adam = adamw_agreement(local, ref_params, st1, st0)
    if launches <= 0 or not adam["tables_bits"] or not adam["dense_bits"] \
            or adam["param_bits"] != adam["pieces"]:
        fail(f"launch: sketched AdamW after the sharded step: "
             f"sketch_update launches {launches}, {adam}")
    print(f"[launch] train: yi-9b full width, {LAUNCH_LAYERS} of 48 layers, "
          f"batch {B} x {S}, FSDP placements ({strategy}) on a (1, 1) "
          f"mesh: loss {float(loss0):.6f} and all "
          f"{sum(len(ps) for _, ps in tf.param_leaves(grads0))} gradient "
          f"pieces bitwise the unsharded step's; step {step_s:.3f} s; "
          f"sketched AdamW (ratio 4, rows 3) after each: sketch_update "
          f"launches {launches} on the sharded path, {adam['sketched']} "
          f"sketched leaves' tables bitwise; dense leaves' params bitwise; "
          f"sketched leaves' params {adam['param_bits']} of {adam['pieces']} "
          f"pieces bitwise; {card()}")
    out = dict(launches=launches, card_args=card_args, base=base, peak=peak)
    del pd, bd, local, ref_params, st0, st1, grads0, grads1, g1
    gc.collect()
    torch.cuda.empty_cache()
    return out


EMULATED_RANKS = 4
STRIDED_WINDOWS = 3


def launch_emulated_ranks(dev):
    """FSDP's sketched AdamW step of one yi-9b leaf emulated over
    ``EMULATED_RANKS`` ranks in this process: the w_gate leaf at
    ``LAUNCH_LAYERS`` layers of (4096, 11008), split along its 11,008
    columns as ``_fsdp_leaf_spec`` splits it (torch.chunk), so each rank's
    block of a layer is one strided piece (rows of 2,752 elements 11,008
    apart).  Each rank's pieces go through the kernel's accumulate into
    zero tables (b1 = b2 = 0), the partial tables are summed in rank
    order and folded as the optimizer folds them (``b * 0 + (1 - b) *
    sum``); the folded tables must lie within 1e-5 of max|table| of the
    unsharded accumulate's, and each rank's strided apply (the kernel's
    step) from them must give params within lr x D + one bf16 ulp of the
    unsharded apply's, D the largest difference of the update direction
    the two tables give through the plain estimates."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.sketch_update import accumulate, step
    from repro_torch.sketch.hashing import cached_coeffs
    from repro_torch.sketch.optimizer import _cols_for, block_pieces
    from repro_torch.train.optimizer import bias_corrections
    cfg = get_config("yi-9b")
    L, rows, cols, R = LAUNCH_LAYERS, cfg.d_model, cfg.d_ff, 3
    n = rows * cols
    C = _cols_for(L * n, 4, R)
    a_ = LAUNCH_ADAMW
    bc1, bc2 = bias_corrections(a_["b1"], a_["b2"], 1)
    hyper = dict(lr=a_["lr"], eps=a_["eps"],
                 weight_decay=a_["weight_decay"], bc1=bc1, bc2=bc2)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    g = [torch.randn(rows, cols, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(L)]
    p = [(0.02 * torch.randn(rows, cols, generator=gen, device=dev)).to(
        torch.bfloat16) for _ in range(L)]
    cm, cv = (cached_coeffs(SEED + 6, R, device=dev),
              cached_coeffs(SEED + 7, R, device=dev))
    zeros = lambda: torch.zeros((R, C), dtype=torch.float32, device=dev)
    um, uv = zeros(), zeros()
    whole = [(t, l * n) for l, t in enumerate(g)]
    accumulate(whole, um, uv, cm, cv, b1=a_["b1"], b2=a_["b2"])
    up = [t.clone() for t in p]
    step(whole, [t.reshape(-1) for t in up], um, uv, cm, cv, **hyper)
    w = -(-cols // EMULATED_RANKS)
    spans = [(r * w, min(cols, (r + 1) * w)) for r in range(EMULATED_RANKS)]
    blocks = []
    for c0, c1 in spans:
        pieces = []
        for l in range(L):
            [(_, off, row, stride)] = block_pieces((rows, cols),
                                                   (rows, c1 - c0), (0, c0),
                                                   l * n)
            pieces.append((g[l][:, c0:c1].contiguous(), off, row, stride))
        blocks.append(pieces)

    def ranks():
        """Every rank's partial tables summed in rank order and folded,
        then every rank's strided apply from them: (fm, fv, params)."""
        sm, sv = zeros(), zeros()
        for pieces in blocks:
            zm, zv = zeros(), zeros()
            accumulate(pieces, zm, zv, cm, cv, b1=0.0, b2=0.0)
            sm += zm
            sv += zv
            del zm, zv
        fm = a_["b1"] * zeros() + (1.0 - a_["b1"]) * sm
        fv = a_["b2"] * zeros() + (1.0 - a_["b2"]) * sv
        sp = [t.clone() for t in p]
        for (c0, c1), pieces in zip(spans, blocks):
            work = [t[:, c0:c1].contiguous() for t in sp]
            step(pieces, [t.reshape(-1) for t in work], fm, fv, cm, cv,
                 **hyper)
            for t, wk in zip(sp, work):
                t[:, c0:c1] = wk
        return fm, fv, sp

    from repro_torch.kernels.sketch_update import sketch_update
    sketch_update.launches = 0
    fm, fv, sp = ranks()
    launches = sketch_update.launches
    # the rank partials are summed in another association than the
    # unsharded accumulate's by design (the 1e-5 gate below), but the
    # emulated ranks themselves repeat bitwise
    fm2, fv2, sp2 = ranks()
    again = (torch.equal(fm2, fm) and torch.equal(fv2, fv)
             and all(torch.equal(x, y) for x, y in zip(sp2, sp)))
    del fm2, fv2, sp2
    if not again:
        fail("launch: emulated ranks: a second run's folded tables or "
             "params differ from the first's")
    t_err = max(float((x - y).abs().max() / y.abs().max())
                for x, y in ((fm, um), (fv, uv)))
    D = worst = 0.0
    bits = 0
    for l in range(L):
        d = []
        for mt, vt in ((um, uv), (fm, fv)):
            mh, vh = kref.sketch_retrieve_ref(n, l * n, mt, vt, cm, cv)
            d.append((mh / bc1) / (torch.sqrt(vh.clamp(min=0) / bc2)
                                   + a_["eps"]))
            del mh, vh
        Dl = float((d[0] - d[1]).abs().max())
        D = max(D, Dl)
        del d
        y1, y0 = sp[l].float().reshape(-1), up[l].float().reshape(-1)
        _, e = torch.frexp(torch.maximum(y1.abs(), y0.abs()))
        ulp = torch.ldexp(torch.ones_like(y1), e - 1) * torch.finfo(
            torch.bfloat16).eps
        worst = max(worst, float(((y1 - y0).abs() / (a_["lr"] * Dl + ulp))
                                 .max()))
        bits += torch.equal(sp[l], up[l])
        del y1, y0, e, ulp
    if t_err > 1e-5 or worst > 1.0:
        fail(f"launch: emulated ranks: tables {t_err:.3g} of max|table|, "
             f"params worst |dp| / (lr D + ulp) {worst:.3g}")
    # one rank's work timed: its strided pieces accumulated into zero
    # tables, then its step from the folded tables, each a mean of 50
    # calls in each of STRIDED_WINDOWS windows; the plain versions on the
    # same pieces, a mean of 10.  The kernels' records read low in some
    # profiler windows (the step 4.6-7.5 ms) while the same windows' host
    # wall and CUDA events hold at ~8.3 ms a step (NVIDIA H100 80GB
    # HBM3), so the times are the events' (each call's host-side launch
    # included); the records, the step's also on fresh copies of the
    # tables, are printed beside them.  Bound: the fused form's bytes (g
    # once, both tables read and written once, the bf16 params read and
    # written once)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    pieces = blocks[0]
    work = [t[:, spans[0][0]:spans[0][1]].contiguous().reshape(-1)
            for t in sp]
    zm, zv = zeros(), zeros()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def by_events(fn):
        fn()
        means = []
        for _ in range(STRIDED_WINDOWS):
            t = 0.0
            for _ in range(50):
                flush.bitwise_not_()
                ev[0].record()
                fn()
                ev[1].record()
                ev[1].synchronize()
                t += ev[0].elapsed_time(ev[1])
            means.append(t / 50)
        return means

    def by_records(fn):
        return zip(*[device_ms(fn, 50, flush)[::2]
                     for _ in range(STRIDED_WINDOWS)])

    run_acc = lambda: accumulate(pieces, zm, zv, cm, cv, b1=0.0, b2=0.0)
    run_step = lambda: step(pieces, work, fm, fv, cm, cv, **hyper)
    accs, steps = by_events(run_acc), by_events(run_step)
    acc_rec, acc_walls = by_records(run_acc)
    step_rec, step_walls = by_records(run_step)
    fm2, fv2 = fm.clone(), fv.clone()
    fresh, _ = by_records(lambda: step(pieces, work, fm2, fv2, cm, cv,
                                       **hyper))
    del fm2, fv2
    acc_ms, step_ms = sum(accs) / len(accs), sum(steps) / len(steps)
    plain_ms = device_ms(lambda: (
        kref.sketch_accumulate_ref(pieces, zm, zv, cm, cv, 0.0, 0.0),
        kref.sketch_step_ref(pieces, work, fm, fv, cm, cv, **hyper)), 10,
        flush)[0]
    N = sum(pc[0].numel() for pc in pieces)
    abytes = N * 2 + 2 * 2 * R * C * 4 + 2 * N * 2
    flops = N * (3 + 2 * R + R * (R - 1) + (R - 1)) + 2 * R * C
    s_bound, s_by = bound(abytes, flops)
    strided = dict(kernel_ms=acc_ms + step_ms, accumulate_ms=acc_ms,
                   step_ms=step_ms, plain_ms=plain_ms, bound_ms=s_bound,
                   bound_by=s_by, launches=launches)
    ms = lambda xs: " / ".join(f"{x:.5f}" for x in xs)
    print(f"[launch] emulated FSDP ranks, one rank's strided pieces timed "
          f"({len(pieces)} pieces, {N} elements, tables ({R}, {C})): "
          f"accumulate {acc_ms:.5f} ms + step {step_ms:.5f} ms (CUDA "
          f"events, means of 50 calls; windows: accumulate {ms(accs)}, "
          f"step {ms(steps)}; profiler kernel records: accumulate "
          f"{ms(acc_rec)} (host wall a call {ms(acc_walls)}), step "
          f"{ms(step_rec)} (host wall {ms(step_walls)}), step on fresh "
          f"copies of the tables {ms(fresh)}); plain "
          f"{plain_ms:.5f} ms (mean of 10); bound_ms={s_bound:.6f} ({abytes}"
          f" B, {s_by}); sketch_update launches in the emulated ranks' check "
          f"{launches}; {card()}", flush=True)
    del flush, zm, zv, work
    print(f"[launch] emulated FSDP ranks: yi-9b w_gate, {L} layers of "
          f"({rows}, {cols}), tables ({R}, {C}), split along the {cols} "
          f"columns over {EMULATED_RANKS} ranks (one strided piece a rank "
          f"and layer: rows of {spans[0][1] - spans[0][0]} elements {cols} "
          f"apart): the partial tables summed in rank order and folded "
          f"within {t_err:.3g} of max|table| of the unsharded accumulate; "
          f"each rank's strided apply from them: {bits} of {L} layers "
          f"bitwise the unsharded apply, every element within lr x D + 1 "
          f"ulp (D {D:.3g}, worst |dp| / bound {worst:.3g}); a second "
          f"run of the ranks bitwise the first (tables and params); "
          f"{card()}",
          flush=True)
    del g, p, up, sp, um, uv, fm, fv, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return strided


EMULATED_KV_POS = (700, 1500, 2600, 3100, 4000, 5200, 6900, 8100)


def launch_emulated_kv(dev):
    """The sharded two-span attention and fold on ``EMULATED_RANKS``
    emulated ``kv_blocks`` ranks in this process (models/ranks.py:
    ``run_ranks``, each collective over the ranks in rank order):
    gemma-2b at full width, one layer, 8 slots at the long geometry
    (max_seq 8192, Z 3, C 1024, window 1024), the pool split by blocks and
    the tails by 256-column shards.  The tails hold each slot's rows
    below its window (an unsharded fold); then one decode chunk's fold (32
    rows a slot, ``kv_sketch.fold_pool_rank``) must leave each rank's
    shard bitwise the unsharded fold's columns, and one decode step of the
    layer (``layers.paged_attention_rank``) must give select estimates
    bitwise the unsharded ``tail_scores`` kernel's, the tail span's
    statistics m and l bitwise and acc within 1e-4 x max|acc| of the
    unsharded ``tail_attend``'s, and an f32 attention output within 1e-3
    x max|output| of the unsharded step's (``paged_attention_op``,
    ``tail_attend`` and ``kv_sketch.two_span_output`` on the whole pool
    and tails): the exact span's split-KV merge rounds p to bf16 at each
    rank's running max, which the card read at 1.9e-4 x max|output|.
    Returns the kernels' launches in the emulated ranks' fold and step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.count_sketch import count_sketch
    from repro_torch.kernels.kv_sketch import (tail_fold, tail_products,
                                               tail_scores, tail_select)
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import layers as ly
    from repro_torch.models import model as M
    from repro_torch.models import ranks
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_sketch as kvs
    n = EMULATED_RANKS
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=1)
    params = tf.init_params(cfg, seed=SEED + 8, device=dev)
    p = params["blocks"][0]["attn"]
    B, W, Z = len(EMULATED_KV_POS), LONG["window"], LONG["rows"]
    C = kvs.tail_cols(LONG["max_seq"], LONG["ratio"])
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = M.init_slot_cache(cfg, B, LONG["max_seq"], dev, (1, n),
                              tail=(Z, C))
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    for k in ("k", "v"):
        cache["kv"][k].copy_(torch.randn(cache["kv"][k].shape, generator=gen,
                                         device=dev))
    pool, tables, tail = cache["kv"], cache["tables"], cache["tail"]
    NB = pool["k"].shape[1] - 1
    pos = torch.tensor(EMULATED_KV_POS, device=dev)[:, None]
    # the window's exact span starts at a block boundary W below the
    # query; the chunk's fold then takes up to 32 of the rows in between
    ff = torch.clamp((pos[:, 0] - W) // 16 * 16 - 32, min=0).to(torch.int32)
    fl = torch.clamp((pos[:, 0] - W) // 16 * 16 - ff, 0, 32).to(torch.int32)
    coeffs = kvs.tail_coeffs(cfg.serve, device=dev)
    kvs.fold_pool(pool, tail, tables, torch.zeros_like(ff), ff, coeffs,
                  int(ff.max()))
    per, w = (NB + 1) // n, C // n
    shards = [(pool["k"][:, r * per:(r + 1) * per].clone(),
               pool["v"][:, r * per:(r + 1) * per].clone(),
               tail[..., r * w:(r + 1) * w, :, :].clone()) for r in range(n)]
    counters = (tail_fold, tail_products, tail_select, paged_attention,
                count_sketch)
    for c in counters:
        c.launches = 0
    got_tails = ranks.run_ranks([kvs.fold_pool_rank(
        sk, sv, r * per, NB, st, r * w, C, tables, ff, fl, coeffs, 32)
        for r, (sk, sv, st) in enumerate(shards)])
    fold_launches = tail_fold.launches
    torch.cuda.synchronize()
    kvs.fold_pool(pool, tail, tables, ff, fl, coeffs, 32)
    fold_bits = all(torch.equal(t, tail[..., r * w:(r + 1) * w, :, :])
                    for r, t in enumerate(got_tails))
    fb = ff + fl
    sketch = {"coeffs": coeffs, "pos_hash": kvs.pos_buckets_signs(
        coeffs, kvs.pos_domain(LONG["max_seq"], 16), C)}
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    q, kn, vn = ly._project_qkv_rope(p, x, cfg, pos)
    qg = q.reshape(B, 1, K, H // K, hd)
    estimates = []
    select = kops.tail_select_op

    def spy(prod, *a, **k):
        out = select(prod, *a, **k)
        estimates.append(out)
        return out

    kops.tail_select_op = spy
    try:
        outs = ranks.run_ranks([ly.paged_attention_rank(
            qg, kn, vn, pos, tables.long(), fb, sk[0], sv[0], r * per, NB,
            None, (st[0, 0], st[1, 0]), sketch, r * w,
            ly.padded_rows(H // K))
            for r, (sk, sv, st) in enumerate(zip(
                [s[0] for s in shards], [s[1] for s in shards], got_tails))])
    finally:
        kops.tail_select_op = select
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    launches["tail_fold"] = fold_launches
    # the unsharded step: the rows written, the two spans merged (as
    # layers.paged_attend, before its cast to the activations' dtype)
    at = (torch.gather(tables.long(), 1, pos // 16), pos % 16)
    pool["k"][0].index_put_(at, kn)
    pool["v"][0].index_put_(at, vn)
    m_e, l_e, acc_e = kops.paged_attention_op(
        qg, pool["k"][0, :NB], pool["v"][0, :NB], tables, pos[:, 0].to(
            torch.int32).contiguous(), fb)
    m_t, l_t, acc_t = kvs.tail_attend(
        qg, tail[0, 0], tail[1, 0], coeffs, sketch["pos_hash"], fb,
        1.0 / hd ** 0.5, slab=ly.padded_rows(H // K))
    want = kvs.two_span_output(
        fb, acc_e / torch.clamp(l_e, min=1e-30)[..., None], m_e, l_e, acc_e,
        m_t, l_t, acc_t)
    est = tail_scores(kvs._query_rows(qg), tail[0, 0], coeffs,
                      sketch["pos_hash"].bk.shape[1])
    torch.cuda.synchronize()
    est_bits = len(estimates) == n and all(torch.equal(e, est)
                                           for e in estimates)
    # the tail span alone (f32 throughout): the ranks' statistics against
    # the unsharded ones, m and l bitwise (the same estimates), acc within
    # 1e-4 x max|acc|
    spans = ranks.run_ranks([kvs.tail_attend_rank(
        qg, st[0, 0], st[1, 0], coeffs, sketch["pos_hash"], fb,
        1.0 / hd ** 0.5, r * w, slab=ly.padded_rows(H // K))
        for r, st in enumerate(got_tails)])
    ml_bits = all(torch.equal(a[0], m_t) and torch.equal(a[1], l_t)
                  for a in spans)
    t_err = max(float((a[2] - acc_t).abs().max()) for a in spans)
    t_tol = 1e-4 * float(acc_t.abs().max())
    # the merged output: the exact span's split-KV merge rounds p to bf16
    # at each rank's running max (kernels/csrc/paged_attention.cu:
    # numerics), not at the unsharded kernel's; the card reads 1.9e-4 x
    # max|output| (NVIDIA H100 80GB HBM3), gated at 1e-3 x max|output|
    err = max(float((o - want).abs().max()) for o in outs)
    tol = 1e-3 * float(want.abs().max())
    written = all(torch.equal(s[k_][0], pool[kk][0, r * per:(r + 1) * per])
                  for r, s in enumerate(shards)
                  for k_, kk in ((0, "k"), (1, "v")))
    if not (fold_bits and est_bits and ml_bits and t_err <= t_tol
            and err <= tol and written) or min(launches.values()) <= 0:
        fail(f"launch: emulated kv_blocks ranks: fold shards bitwise "
             f"{fold_bits}, select estimates bitwise {est_bits}, tail m and "
             f"l bitwise {ml_bits}, tail acc err {t_err:.3g} (tol "
             f"{t_tol:.3g}), output err {err:.3g} (tol {tol:.3g}), rows "
             f"written bitwise {written}, launches {launches}")
    print(f"[launch] emulated kv_blocks ranks: gemma-2b full width, one "
          f"layer, {B} slots at max_seq {LONG['max_seq']}, window {W}, tails "
          f"Z {Z} x C {C}, pool of {NB + 1} blocks and the tails split over "
          f"{n} ranks ({per} blocks, {w} columns each): the decode chunk's "
          f"fold (up to 32 rows a slot; fold_base {fb.tolist()}) bitwise the "
          f"unsharded fold's columns on every rank; one decode step: select "
          f"estimates bitwise the unsharded tail_scores kernel's on every "
          f"rank; the tail span's m and l bitwise, its acc within "
          f"{t_err:.3g} (1e-4 x max|acc| = {t_tol:.3g}); attention output "
          f"(f32, before the cast) within {err:.3g} of the unsharded step's "
          f"({err / float(want.abs().max()):.3g} of max|output|; gate 1e-3 x"
          f" max|output| = {tol:.3g}: bf16 p at each rank's running max); "
          f"new rows written bitwise; launches {launches}; "
          f"{card()}", flush=True)
    del params, cache, pool, tail, shards, got_tails, outs, estimates
    gc.collect()
    torch.cuda.empty_cache()
    return launches


EMULATED_EP_TOKENS = (8, 128)


def launch_emulated_ep(dev):
    """Expert-parallel MoE on ``EMULATED_RANKS`` emulated ranks in this
    process: one deepseek-moe-16b layer at full width (64 experts, 16 a
    rank), forward and backward at 8 x 128 tokens, each rank routing every
    token and running its own experts (``moe.moe_rank``), the experts'
    outputs gathered in rank order before the combine.  Output, aux loss and
    expert gradients against the gathered form (``moe_ffn`` with all 64):
    the combine gathers the experts' outputs and each expert's GEMMs are
    the same launches, so they must agree bitwise; the input's gradient
    (its experts' shares summed in another order) within GRAD_TOL["bf16"]
    of max."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.models import ranks
    from repro_torch.models import transformer as tf
    n = EMULATED_RANKS
    tol = 0.03                     # tests/test_torch_distributed.py GRAD_TOL
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1)
    E = cfg.moe.num_experts
    p = tf.init_params(cfg, seed=SEED + 10, device=dev)["blocks"][0]["moe"]
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    Bt, St = EMULATED_EP_TOKENS
    x = torch.randn((Bt, St, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    gy = torch.randn((Bt, St, cfg.d_model), generator=gen, device=dev)
    leaves = moe.EXPERT_LEAVES

    def grads(y, aux, wrt):
        return torch.autograd.grad((y.float() * gy).sum() + aux, wrt)

    pa = {k: v.clone().requires_grad_(k in leaves) for k, v in p.items()}
    xa = x.clone().requires_grad_(True)
    t0 = time.perf_counter()
    want, aux = moe.moe_ffn(pa, xa, cfg, with_aux=True)
    wg = grads(want, aux, [xa] + [pa[k] for k in leaves])
    torch.cuda.synchronize()
    t_gathered = time.perf_counter() - t0
    ex = {k: p[k].clone().requires_grad_(True) for k in leaves}
    xb = x.clone().requires_grad_(True)
    El = E // n
    t0 = time.perf_counter()
    bodies = []
    for r in range(n):
        lp = {k: v for k, v in p.items() if k not in leaves}
        lp.update({k: ex[k][r * El:(r + 1) * El] for k in leaves})
        bodies.append(moe.moe_rank(lp, xb, cfg, with_aux=True,
                                   expert0=r * El))
    outs = ranks.run_ranks(bodies)
    y, a = outs[0]
    gg = grads(y, a, [xb] + [ex[k] for k in leaves])
    torch.cuda.synchronize()
    t_ep = time.perf_counter() - t0
    rel = lambda got, w: float((got.detach().float() - w.detach().float())
                               .abs().max() / w.detach().float().abs().max()
                               .clamp(min=1e-30))
    out_bits = all(torch.equal(o[0], want) for o in outs)
    grad_bits = [torch.equal(g_, w_) for g_, w_ in zip(gg[1:], wg[1:])]
    errs = {"output": max(rel(o[0], want) for o in outs),
            "dx": rel(gg[0], wg[0])}
    errs.update({k: rel(g_, w_) for k, g_, w_ in zip(leaves, gg[1:],
                                                      wg[1:])})
    aux_bits = all(torch.equal(o[1], aux) for o in outs)
    if not (out_bits and all(grad_bits) and aux_bits) or errs["dx"] > tol:
        fail(f"launch: emulated EP ranks: output bitwise {out_bits}, expert "
             f"gradients bitwise {dict(zip(leaves, grad_bits))}, aux equal "
             f"{aux_bits}; relative errors {errs} (dx tol {tol})")
    print(f"[launch] emulated EP ranks: deepseek-moe-16b full width, one "
          f"layer, {E} experts over {n} ranks ({El} each), {Bt} x {St} "
          f"tokens, forward and backward: output bitwise the gathered form's "
          f"{out_bits}, expert gradients bitwise {dict(zip(leaves, grad_bits))}"
          f"; max |diff| / max of the gathered form: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (dx tol {tol}); aux loss equal; host wall gathered "
          f"{t_gathered:.3f}"
          f" s, emulated ranks {t_ep:.3f} s; {card()}", flush=True)
    del p, pa, ex, outs, wg, gg
    gc.collect()
    torch.cuda.empty_cache()


def launch_podwise(dev, mesh):
    """The pod-wise compressed step over a pod group of one against the
    plain compressed step, yi-9b as in ``launch_train``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import grad_compress as gcm
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=LAUNCH_LAYERS)
    B, S = TRAIN["batch"], TRAIN["seq"]
    params = tf.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :S].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    seen = {}

    def probe(c, pieces, tables, sk):
        seen.setdefault(c.leaf_id, []).append(sk.clone())

    gcm.probe = probe
    try:
        ef = gcm.init_error_feedback(params)
        step = gcm.make_podwise_compressed_step(cfg, mesh)
        loss, grads, _ = step(params, ef, batch, 1)
        plain = gcm.make_compressed_train_step(cfg)
        loss0, grads0, _ = plain(params, ef, batch, 1)
    finally:
        gcm.probe = None
    codecs = gcm._leaf_codecs(params, cfg.sketch.grad_hash_ratio)
    leaves = tf.param_leaves(grads)
    n_bits = n_sketch_bits = 0
    worst = 0.0
    for (name, pieces), c in zip(leaves, codecs):
        if c is None:
            continue
        sk_pod, sk_plain = seen[c.leaf_id]
        tables = gcm.codec_hashes(c, cfg.sketch.seed, 1, dev)
        est = gcm.unsketch_leaf(sk_pod, c, tables, pieces, pieces[0].dtype)
        n_bits += all(torch.equal(a, b) for a, b in zip(est, pieces))
        n_sketch_bits += torch.equal(sk_pod, sk_plain)
        worst = max(worst, float((sk_pod - sk_plain).abs().max()
                                 / sk_plain.abs().max().clamp(min=1e-30)))
    n_comp = sum(c is not None for c in codecs)
    want = sum(4 * c.Jt for c in codecs if c is not None)
    sent = step.allreduced["sketch"]
    if n_comp == 0 or n_bits != n_comp or sent != want \
            or n_sketch_bits != n_comp:
        fail(f"launch: pod-wise step: {n_bits} of {n_comp} estimates "
             f"bitwise unsketch_leaf of the pod-mean sketch, sketch bytes "
             f"{sent} vs sum J~ x 4 = {want}, sketches vs the plain "
             f"compressed step's max rel {worst}")
    print(f"[launch] podwise: pod group of one, {n_comp} compressed leaves: "
          f"every estimate bitwise unsketch_leaf of the pod-mean sketch; "
          f"sketches {n_sketch_bits} of {n_comp} bitwise the plain "
          f"compressed step's; all-reduced {sent} B of sketches = "
          f"sum J~ x 4 B, plus {step.allreduced['dense']} B of uncompressed "
          f"leaves and loss; loss {float(loss):.6f} (plain "
          f"{float(loss0):.6f})")
    del params, grads, grads0, seen
    gc.collect()
    torch.cuda.empty_cache()


def launch_serve(dev, mesh):
    """gemma-2b at full width, ``LAUNCH_SERVE_LAYERS`` layers: decode steps
    through ``make_serve_step`` at the decode TP placements on the (1, 1)
    mesh against the unsharded serve step; returns paged_attention's
    launches on the sharded path."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import logical_rules
    cfg = dataclasses.replace(get_config("gemma-2b"),
                              num_layers=LAUNCH_SERVE_LAYERS)
    B, max_seq = 8, 512
    rules, _ = SH.make_rules(cfg, "decode", False, False)
    params = tf.init_params(cfg, seed=SEED, device=dev)
    pd = SH.distribute(params, SH.build_param_pspecs(cfg, params, rules,
                                                     "tp"), mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cache = M.init_slot_cache(cfg, B, max_seq, dev,
                              SH.cache_split(rules, sizes))
    ref_cache = tf.tree_map(lambda t: t.clone(), cache)
    cd = SH.distribute(cache, SH.cache_pspecs(cfg, cache, rules), mesh)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (LAUNCH_DECODE_STEPS, B, 1),
                         generator=gen, device=dev)
    start = torch.randint(0, max_seq - LAUNCH_DECODE_STEPS, (B,),
                          generator=gen, device=dev).to(torch.int32)
    step = M.make_serve_step(cfg)
    paged_attention.launches = 0
    with LaunchShapes() as shapes:
        with logical_rules(rules), implicit_replication():
            got = [step(pd, cd, toks[i], start + i)[0].full_tensor()
                   for i in range(LAUNCH_DECODE_STEPS)]
        torch.cuda.synchronize()
        launches = paged_attention.launches
        local = local_tree(pd)
        want = [step(local, ref_cache, toks[i], start + i)[0]
                for i in range(LAUNCH_DECODE_STEPS)]
    shapes.check("phase launch")
    pool = local_tree(cd)["kv"]
    same_logits = all(torch.equal(a, b) for a, b in zip(got, want))
    same_pool = all(torch.equal(pool[k].view(torch.int16),
                                ref_cache["kv"][k].view(torch.int16))
                    for k in ("k", "v"))
    if not (same_logits and same_pool) or launches <= 0:
        fail(f"launch: serve step at the decode TP placements: logits "
             f"bitwise {same_logits}, pool rows bitwise {same_pool}, "
             f"paged_attention launches {launches}")
    print(f"[launch] serve: gemma-2b full width, {LAUNCH_SERVE_LAYERS} of 18 "
          f"layers, {B} slots, {LAUNCH_DECODE_STEPS} decode steps through "
          f"make_serve_step at the decode TP placements on a (1, 1) mesh: "
          f"logits and pool rows bitwise the unsharded step's; "
          f"paged_attention launches {launches}")
    del params, pd, cache, cd, ref_cache, local, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_launch(dev):
    """The launch tooling (``launch/``, ``models/sharding.py``) on the card:
    a world-1 NCCL group through a ``FileStore`` (no TCP port), a (1, 1)
    mesh, the sharded train, pod-wise and serve steps held bitwise to the
    unsharded ones, and the dry run's estimate beside the card."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        try:
            dist.init_process_group(
                "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()))
        except Exception as e:     # the phase needs NCCL: no fallback
            fail(f"launch: NCCL process group of one: {e!r}")
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            pod = make_mesh((1,), ("pod",), "cuda")
            train = launch_train(dev, mesh)
            strided = launch_emulated_ranks(dev)
            kv_launches = launch_emulated_kv(dev)
            launch_emulated_ep(dev)
            launch_podwise(dev, pod)
            serve_launches = launch_serve(dev, mesh)
        finally:
            dist.destroy_process_group()
    t_wait = time.perf_counter()
    cells, ran_s = collect_dryrun()
    cells = cells[len(TRAIN_4K_CELLS):]
    wait = time.perf_counter() - t_wait
    cut = cells[0]["memory"]
    measured = train["card_args"] + train["peak"] - train["base"]
    ratio = cut["peak_bytes_per_device"] / measured
    if cut["argument_bytes_per_device"] != train["card_args"] \
            or not 0.67 <= ratio <= 1.5:
        fail(f"launch: dry run at (1, 1): argument bytes "
             f"{cut['argument_bytes_per_device']} vs the card's "
             f"{train['card_args']}; peak {cut['peak_bytes_per_device']} "
             f"vs measured {measured} (ratio {ratio:.3f})")
    print(f"[launch] dry run vs card: yi-9b {LAUNCH_LAYERS} layers, batch "
          f"{TRAIN['batch']} x {TRAIN['seq']}, (1, 1) mesh: argument bytes "
          f"{cut['argument_bytes_per_device']} = the card's params + batch "
          f"{train['card_args']}; estimated peak "
          f"{cut['peak_bytes_per_device']} B (activations "
          f"{cut['activation_peak_bytes_per_device']}) vs measured "
          f"{measured} B (max_memory_allocated {train['peak']} since a "
          f"reset at {train['base']} B allocated, plus the arguments): "
          f"ratio {ratio:.4f}; {card()}")
    for c in cells[1:]:
        rf, mem = c["roofline"], c["memory"]
        print(f"[launch] dry run {c['arch']} {c['shape']} {c['mesh']} "
              f"({c['strategy']}): peak {mem['peak_bytes_per_device']} B/dev"
              f" (args {mem['argument_bytes_per_device']}); compute "
              f"{rf['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{rf['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{rf['t_collective_s'] * 1e3:.3f} ms (ici "
              f"{rf['t_ici_s'] * 1e3:.3f}, dcn {rf['t_dcn_s'] * 1e3:.3f}), "
              f"dominant {rf['dominant']}; walk {c['t_walk_s']} s; H100 SXM "
              f"datasheet rates")
    print(f"[launch] dry-run process (nice 19, one thread): ran {ran_s:.1f} s"
          f" from {_DRYRUN['t0'] - _LAPS[0][1]:.1f} s into the run,"
          f" overlapping {overlapped_phases(_DRYRUN['t0'], ran_s) or 'none'};"
          f" {wait:.1f} s waited for here")
    return {"paged_attention": serve_launches,
            "sketch_update": train["launches"], "kv": kv_launches,
            "strided": strided}


def main() -> None:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    load_rates()
    _LAPS.append(("start", t_run))
    start_dryrun(root)
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

    _LAPS.append(("build", time.perf_counter()))

    def lap(what):
        _LAPS.append((what, time.perf_counter()))
        print(f"[time] {what} {_LAPS[-1][1] - _LAPS[-2][1]:.1f}s (at "
              f"{_LAPS[-1][1] - t_run:.1f}s)", flush=True)

    add_draft_geometries([(a, get_config(a)) for a in
                          ("granite-moe-3b-a800m", "deepseek-moe-16b",
                           "qwen2.5-32b")])
    rows = phase_kernel(flush)
    lap("phase kernel, paged_attention")
    sk_rows = phase_sketch_kernel(flush)
    fold_rows, score_rows = phase_kv_kernels(flush)
    form_rows = phase_kv_forms(flush)
    cs_rows, un_rows = phase_cs_kernels(flush)
    held("the kernel phases (the 256 MB flush buffer held)")
    lap("phases kernel (sketch_update), kv, cs")
    cpd_launches = phase_cpd(dev)
    held("cpd")
    lap("phase cpd")

    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=SEED, device=dev)
    gap = phase_model(cfg, params, dev, flush)
    phase_sketch_model(cfg, params, dev, flush)
    del flush
    lap("phase model")
    with LaunchShapes() as shapes:
        launches = phase_serve(cfg, params, dev, gap)
        lap("phase serve")
        spec_launches = phase_spec(cfg, params, dev)
        lap("phase spec")
        long_launches = phase_long_serve(cfg, params, dev)
        lap("phase long")
        long_spec_launches = phase_long_spec(cfg, params, dev)
        lap("phase long-spec")
    shapes.check("phases serve, spec, long and long-spec")
    del params                               # free gemma-2b for training
    torch.cuda.empty_cache()
    held("serve and long, gemma-2b freed")
    sk_launches, k4_launches = phase_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    held("train, yi-9b freed")
    lap("phase train")
    with LaunchShapes() as shapes:
        moe_launches = phase_moe(dev)
    shapes.check("phase moe")
    lap("phase moe")
    held("moe, its models freed")
    with LaunchShapes() as shapes:
        moe_spec_launches = phase_moe_spec(dev)
    shapes.check("phase moe-spec")
    lap("phase moe-spec")
    held("moe-spec, its models freed")
    phase_recurrent(dev)
    lap("phase recurrent")
    held("recurrent, its models freed")
    fam_launches = phase_train_families(dev)
    lap("phase train-families")
    launch_launches = phase_launch(dev)
    lap("phase launch")

    d = rows["decode"]
    sk = sk_rows[SKETCH_MAIN]
    record = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:89",
        "launches": launches,
        # the speculative paths' own count: phase spec's three engines
        # (draft micro-steps, verify, prefill) and the sketched spec run
        "spec_launches": spec_launches["paged_attention"]
        + long_spec_launches["paged_attention"],
        # phase moe's six engines (their graphed first passes)
        "moe_launches": moe_launches,
        # phase moe-spec's spec engines (draft micro-steps, verify,
        # prefill; their graphed first passes)
        "moe_spec_launches": moe_spec_launches["paged_attention"],
        # phase launch's serve step at the decode TP placements
        "launch_launches": launch_launches["paged_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"]}, {
        "name": "sketch_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_update.cu",
        "replaces": "src/repro/kernels/sketch_update.py:125",
        "launches": sk_launches,
        # phase train's two steps at batch B x 4096
        "train_4k_launches": k4_launches,
        # phase train-families' six runs
        "families_launches": fam_launches,
        # phase launch's sketched AdamW after the sharded step
        "launch_launches": launch_launches["sketch_update"],
        "max_abs_err": max(r["max_abs_err"] for r in sk_rows.values()),
        "ms": sk["kernel_ms"], "plain_ms": sk["plain_ms"],
        "bound_ms": sk["bound_ms"], "bound_by": sk["bound_by"],
        "library_ms": None,
        # ms, plain_ms and bound_ms are the estimates form's (the plain
        # version's contract); the train path runs the fused form
        "apply_ms": sk["apply_ms"], "apply_bound_ms": sk["apply_bound_ms"],
        # phase launch's emulated FSDP ranks: one rank's strided pieces,
        # accumulate and step
        "strided": launch_launches["strided"]}]}
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
            "spec_launches": long_spec_launches[name],
            "max_abs_err": max(g["max_abs_err"] for g in geo.values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # the sharded serve path's forms (phase launch's emulated kv_blocks
    # ranks): the column-range fold, and the products pass on a column
    # shard with its select pass on the gathered products
    kv = launch_launches["kv"]
    for name, replaces, launches, extra in (
            ("tail_fold_cols", "src/repro/kernels/kv_sketch.py:90",
             kv["tail_fold"], {}),
            ("tail_products_cols", "src/repro/kernels/kv_sketch.py:129",
             kv["tail_products"], {"select_launches": kv["tail_select"]})):
        r = form_rows[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kv_sketch.cu",
            "replaces": replaces, "launches": launches, **extra,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
            # draft derivation and the sketched head's activation sketch
            "spec_launches": spec_launches[name],
            # count_sketch: the sketched tail span of the 8k stream
            "long_launches": long_launches.get(name, 0),
            # the moe and qwen2.5 drafts' derivations and sketched heads
            "moe_spec_launches": moe_spec_launches[name],
            "max_abs_err": max(g["max_abs_err"] for g in geo.values()),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(f"[time] every phase passed in {time.perf_counter() - t_run:.1f}s")
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
