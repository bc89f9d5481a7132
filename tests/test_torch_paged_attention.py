"""Port parity: the plain PyTorch paged attention of ``repro_torch``
against the JAX package's oracle and its Pallas kernel (interpret mode,
as tests/test_kernels.py runs it on the CPU), plus the op's device
dispatch.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).

Tolerance: rtol 1e-5 / atol 1e-6 on (m, l, acc).  Both sides walk the
same blocks with the same update equations from the same bf16 inputs;
bf16 x bf16 products are exact in f32, so only the f32 summation order
inside each dot product differs (~1e-7 relative).

The CUDA kernel's split-KV planner (``kernels/paged_attention.py:plan``)
and its plain model ``paged_attention_split_ref`` (defined here) are
checked here too.  The model against the Pallas kernel and the plain
version: m within rtol 1e-5, l within rtol 1e-4, acc / l within
2e-2 x min(1, max|acc / l|) absolute (the kernel's tolerance in
chip_smoke.py), since the model steps its online
softmax once per staged KV tile and per split where the reference steps
per pool block, so p is rounded to bf16 at another running max."""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import (BLOCKS_PER_SM, MAX_SPLITS,
                                                 paged_attention, plan)
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import SlotScheduler

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

# (B, Sq, K, R, hd, NB, bs, nb): decode-, verify- and chunk-shaped cases
# (the geometries of tests/test_kernels.py PAGED_SHAPES)
PAGED_SHAPES = [
    (3, 1, 2, 3, 16, 12, 8, 4),     # single-token decode, GQA
    (2, 4, 2, 2, 32, 10, 4, 5),     # multi-query (C = 4)
    (1, 16, 1, 4, 16, 8, 8, 6),     # chunked prefill (one slot), MQA
    (4, 3, 3, 1, 8, 20, 16, 3),     # R == 1
]


def _paged_inputs(B, Sq, K, R, hd, NB, bs, nb, seed=0):
    """Ragged geometry as in tests/test_kernels.py: per-slot starts, slot
    0's last table entry invalidated, fold_base mixing 0 and bs."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, K, R, hd).astype(np.float32)
    kp = rng.randn(NB, bs, K, hd).astype(np.float32)
    vp = rng.randn(NB, bs, K, hd).astype(np.float32)
    tables = (rng.permutation(NB)[:B * nb].reshape(B, nb) if B * nb <= NB
              else rng.randint(0, NB, (B, nb))).astype(np.int32)
    tables[0, nb - 1] = NB
    start = rng.randint(0, nb * bs - Sq, (B,)).astype(np.int32)
    fb = np.minimum(np.array([0] * (B - B // 2) + [bs] * (B // 2),
                             np.int32), start)
    return q, kp, vp, tables, start, fb


def _jax(args):
    q, kp, vp, tables, start, fb = args
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
            jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
            jnp.asarray(start), jnp.asarray(fb))


def _torch(args, device="cpu"):
    q, kp, vp, tables, start, fb = args
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, kp, vp)]
    ints = [torch.as_tensor(a) for a in (tables, start, fb)]
    return [t.to(device) for t in bf + ints]


def _close(got, want):
    for name, a, b in zip("m l acc".split(), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


H100_SMS = 132


def _chip_geometries():
    """The paged-attention geometries that chip_smoke.py runs on the card
    (the script imports no kernel module at its top, so loading it here
    needs no card)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GEOMETRIES


CHIP_GEOMETRIES = _chip_geometries()


def paged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, tables: torch.Tensor,
                              start: torch.Tensor, fold_base: torch.Tensor,
                              sm_count: int = 132):
    """``paged_attention_ref``'s function through the CUDA kernel's
    decomposition on a card of ``sm_count`` SMs: query rows in i-major
    tiles (tile row tr is head r = tr % R of query i = tr // R), each
    tile's KV in ``plan``'s splits clipped to the positions the tile can
    see, an online softmax per split stepped once per stage of
    ``stage_blocks`` pool blocks, then m = max m_s, l = sum_s
    exp(m_s - m) l_s and acc alike, in increasing s."""
    B, Sq, K, R, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    nb = tables.shape[1]
    NQ = R * Sq
    pl = plan(B, K, NQ, nb, bs, sm_count)
    P = pl.stage_blocks
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.full((B, K, R, Sq), -1e30, **f32)
    l = torch.zeros((B, K, R, Sq), **f32)
    acc = torch.zeros((B, K, R, Sq, hd), **f32)
    tr = torch.arange(NQ, device=dev)
    for b in range(B):
        st, fb = int(start[b]), int(fold_base[b])
        for t in range(pl.tiles):
            rows = tr[t * pl.tile_rows:(t + 1) * pl.tile_rows]
            ii, rr = rows // R, rows % R
            qt = q[b, ii, :, rr].float().transpose(0, 1)      # (K, n, hd)
            lim = st + ii                                     # (n,)
            hi = st + int(ii[-1])
            parts = []
            for s in range(pl.splits):
                j0 = s * pl.per_split
                jlo = max(j0, fb // bs if fb > 0 else 0)
                jhi = (min(min(nb, j0 + pl.per_split) - 1, hi // bs)
                       if hi >= 0 else -1)
                ms = torch.full((K, len(rows)), -1e30, **f32)
                ls = torch.zeros((K, len(rows)), **f32)
                accs = torch.zeros((K, len(rows), hd), **f32)
                for j in range(jlo, jhi + 1, P):
                    ent = tables[b, j:min(j + P, jhi + 1)]
                    live = ((ent >= 0) & (ent < NB)).repeat_interleave(bs)
                    phys = ent.clamp(0, NB - 1).long()
                    kj = k_pool[phys].reshape(-1, K, hd).float()
                    vj = v_pool[phys].reshape(-1, K, hd)
                    pos = j * bs + torch.arange(kj.shape[0], device=dev)
                    ok = (live & (pos >= fb))[None] & (pos[None]
                                                       <= lim[:, None])
                    sc = torch.einsum("knh,ckh->knc", qt, kj) * scale
                    sc = torch.where(ok, sc, torch.full_like(sc, -1e30))
                    m_cur = torch.maximum(ms, sc.max(dim=-1).values)
                    p = torch.where(ok, torch.exp(sc - m_cur[..., None]),
                                    torch.zeros_like(sc))
                    corr = torch.exp(ms - m_cur)
                    ls = ls * corr + p.sum(dim=-1)
                    accs = accs * corr[..., None] + torch.einsum(
                        "knc,ckh->knh", p.to(vj.dtype).float(), vj.float())
                    ms = m_cur
                parts.append((ms, ls, accs))
            mm = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            lm = torch.zeros_like(mm)
            am = torch.zeros_like(parts[0][2])
            for pm, pls, pacc in parts:
                w = torch.exp(pm - mm)
                lm = lm + w * pls
                am = am + w[..., None] * pacc
            m[b][:, rr, ii] = mm
            l[b][:, rr, ii] = lm
            acc[b][:, rr, ii] = am
    return m, l, acc


def _split_inputs():
    """Four splits of three blocks of 4 positions (split boundaries at
    positions 12, 24, 36 with 9 SMs): slot 0's fold_base lies exactly on
    a boundary and its queries end before splits 2-3 (no live key there);
    slot 1's fold_base lies inside split 1 and two of its entries are
    dead; every entry of slot 2's split 1 is dead."""
    args = list(_paged_inputs(3, 2, 2, 2, 16, 40, 4, 10, seed=11))
    args[4][:] = [20, 38, 37]                    # start
    args[5][:] = [12, 17, 0]                     # fold_base
    args[3][1, [2, 5]] = 40
    args[3][2, 3:6] = 40
    return args


def _close_split(got, want):
    m, l, acc = (torch.as_tensor(np.array(a, np.float32)) for a in got)
    mr, lr, ar = (torch.as_tensor(np.array(a, np.float32)) for a in want)
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, lr, rtol=1e-4, atol=1e-6)
    want = ar / lr.clamp(min=1e-30)[..., None]
    torch.testing.assert_close(acc / l.clamp(min=1e-30)[..., None], want,
                               rtol=0, atol=2e-2 * min(
                                   1.0, want.abs().max().item()))


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CHIP_GEOMETRIES))
def test_plan_reaches_the_block_target(name):
    """BLOCKS_PER_SM blocks per SM on an H100, or one split per logical
    block where the slot has fewer; the splits cover the slot's blocks and
    the tiles its query rows."""
    B, Sq, K, R, hd, NB, bs, nb = CHIP_GEOMETRIES[name]
    pl = plan(B, K, R * Sq, nb, bs, H100_SMS)
    most = B * K * pl.tiles * nb
    assert pl.blocks == pl.splits * pl.tiles * B * K
    assert pl.blocks >= min(BLOCKS_PER_SM * H100_SMS, most)
    assert (pl.splits - 1) * pl.per_split < nb <= pl.splits * pl.per_split
    assert pl.tile_rows % 16 == 0 and 16 <= pl.tile_rows <= 64
    assert (pl.tiles - 1) * pl.tile_rows < R * Sq <= pl.tiles * pl.tile_rows
    assert pl.stage_blocks * bs <= 32
    if name == "decode":
        assert pl.blocks >= H100_SMS
    if name == "decode_8k":
        assert pl.blocks >= BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("name", sorted(CHIP_GEOMETRIES))
def test_plan_splits_ignore_the_query_rows(name):
    """The KV splits depend on (B, K, nb, SMs) alone: a decode call, a
    verify call of any Sq and the draft's micro-steps split a slot's
    blocks at the same boundaries (what makes verify rows bitwise decode
    rows on the card), and no call has more than MAX_SPLITS."""
    B, Sq, K, R, hd, NB, bs, nb = CHIP_GEOMETRIES[name]
    one = plan(B, K, R, nb, bs, H100_SMS)
    for sq in range(1, 17):
        pl = plan(B, K, R * sq, nb, bs, H100_SMS)
        assert (pl.splits, pl.per_split) == (one.splits, one.per_split)
        assert pl.splits <= MAX_SPLITS


def test_plan_changes_with_shapes_only():
    """The plan is a function of (B, K, NQ, nb, bs, SMs); a slot's output
    of the split model is bitwise the same when other slots' start,
    fold_base or table entries change (the fold_base == 0 anchor)."""
    assert plan(8, 1, 8, 512, 16, 132) == plan(8, 1, 8, 512, 16, 132)
    assert plan(8, 1, 8, 512, 16, 132).splits > plan(8, 1, 8, 512, 16,
                                                     66).splits
    assert plan(16, 1, 8, 512, 16, 132).splits < plan(8, 1, 8, 512, 16,
                                                      132).splits
    args = _split_inputs()
    base = paged_attention_split_ref(*_torch(args), sm_count=9)
    other = [a.copy() for a in args]
    other[4][1:] = [5, 30]
    other[5][1:] = [4, 24]
    other[3][2] = np.roll(other[3][2], 3)
    moved = paged_attention_split_ref(*_torch(other), sm_count=9)
    for a, b in zip(base, moved):
        assert torch.equal(a[0], b[0])
        assert not torch.equal(a[1:], b[1:])


# ---------------------------------------------------------------------------
# The split model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_split_model_matches_pallas_interpret(shape, sms):
    args = _paged_inputs(*shape, seed=3)
    _close_split(paged_attention_split_ref(*_torch(args), sm_count=sms),
           pallas_paged(*_jax(args), interpret=True))


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_split_model_matches_plain_version(shape, sms):
    args = _torch(_paged_inputs(*shape, seed=4))
    _close_split(paged_attention_split_ref(*args, sm_count=sms),
           ref.paged_attention_ref(*args))


def test_split_model_edge_splits():
    """Fold base on and inside a split boundary, dead entries, splits
    with no live key: against the Pallas kernel and the plain version."""
    args = _split_inputs()
    pl = plan(3, 2, 4, 10, 4, 9)
    assert (pl.splits, pl.per_split) == (4, 3)
    got = paged_attention_split_ref(*_torch(args), sm_count=9)
    _close_split(got, pallas_paged(*_jax(args), interpret=True))
    _close_split(got, ref.paged_attention_ref(*_torch(args)))


def test_split_model_dead_slot():
    """A slot whose every entry is dead: m = -1e30, l = 0, acc = 0."""
    args = _paged_inputs(*PAGED_SHAPES[0], seed=5)
    args[3][1, :] = args[1].shape[0]
    m, l, acc = paged_attention_split_ref(*_torch(args))
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0)
    assert torch.all(acc[1] == 0)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_matches_reference_oracle(shape):
    args = _paged_inputs(*shape)
    _close(ref.paged_attention_ref(*_torch(args)),
           jref.paged_attention_ref(*_jax(args)))


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_matches_pallas_interpret(shape):
    args = _paged_inputs(*shape, seed=3)
    _close(ref.paged_attention_ref(*_torch(args)),
           pallas_paged(*_jax(args), interpret=True))


def test_dead_row_statistics():
    """A slot whose every table entry is dead returns m = -1e30, l = 0,
    acc = 0 (what a later span merge expects), not NaN."""
    args = list(_paged_inputs(*PAGED_SHAPES[0], seed=5))
    args[3][1, :] = args[1].shape[0]
    m, l, acc = ref.paged_attention_ref(*_torch(args))
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0)
    assert torch.all(acc[1] == 0)


def test_op_sends_cpu_tensors_to_plain_version():
    args = _torch(_paged_inputs(*PAGED_SHAPES[1], seed=7))
    before = paged_attention.launches
    for a, b in zip(ops.paged_attention_op(*args),
                    ref.paged_attention_ref(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert paged_attention.launches == before


def test_kernel_requested_on_cpu_raises():
    args = _torch(_paged_inputs(*PAGED_SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_op(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*args)


def test_scheduler_paged_kernels_true_on_cpu_raises():
    import dataclasses
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, device="cpu")
    serve = dataclasses.replace(cfg.serve, paged_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        SlotScheduler(cfg, params, serve=serve, device="cpu")
