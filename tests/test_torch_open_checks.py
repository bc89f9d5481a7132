"""Two behaviours the card showed in the port, each checked here against
the JAX package on the CPU: is it the reference's too, or the port's?

MoE speculation parting at prefill pad rows.  A speculative engine
reserves ``spec_k`` overhang rows a slot, so the pad rows of a prompt's
last prefill chunk (token 0 past the prompt) that fall past a plain
engine's reserved blocks attend a live block in the spec engine and the
write sink's masked one in the plain engine.  They route apart; in the
k-major queue their first choices come before the real rows' second
choices, so they move which real choices drop, and through the next
layer a request's KV and tokens.  Here both packages' plain and spec
engines serve prompts whose last chunk straddles that boundary, with
every MoE call of every prefill chunk recorded: the reference's two
engines route the pad rows apart and move real rows' drops as the
port's do, and a request's greedy tokens part in the reference as they
do in the port.  Shared with the reference.

Sketched RTPM at Fig. 1's D 2 recovers no factors.  Both packages from
the same tensor, hashes (the reference's, through numpy) and inits, at
Fig. 1's I 100, rank 10, sigma 0.01, L 15, T 20 and J 1000: the clean
residual ||T_clean - T_hat|| / ||T_clean|| stays above 0.9 in both, TS
and FCS alike, while plain RTPM from the same inits reaches 0.18 in
both.  Shared with the reference.  ``tools/rtpm_d2.py`` runs every J of
Fig. 1 (1000, 4000, 10000) for both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rc
from repro.cpd import rtpm as ref_rtpm
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.cpd import rtpm
from repro_torch.launch.cpd import FIG1, symmetric_tensor
from repro_torch.models import moe
from repro_torch.models.bridge import mode_hashes_from_reference
from repro_torch.models.routing import RoutingProbe
from repro_torch.serve.scheduler import Request, SlotScheduler
from test_torch_moe_serve import _configs, _params

torch.set_num_threads(1)

# prompt lengths whose S + MAX_NEW falls in the last 4 rows of a 16-row
# block (44 < S + 4 <= 48, 76 < S + 4 <= 80): the last 32-row prefill
# chunk's pad rows past that block are the plain engine's write sink and
# the spec engine's (spec_k 4) overhang block
LENS = (41, 43, 44, 73, 75, 76)
MAX_NEW = 4
SPEC = dict(spec_k=4, draft_depth=1)


def _serve(cfg, **kw):
    return dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                               decode_chunk=4, prefill_bucket=32,
                               kv_block_size=16, **kw)


def _prompts(cfg):
    rng = np.random.RandomState(3)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
            for n in LENS]


def _reference(monkeypatch, cfg, params, prompts, **kw):
    """The reference engine's prefill chunks {(tokens, off): the target's
    top_k (rows, K) a layer} and greedy tokens {rid: tokens}."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    calls = []
    top_k = jax.lax.top_k

    def recorded(a, k):
        out = top_k(a, k)
        if a.shape[-1] == E and k == K:
            jax.debug.callback(lambda t: calls.append(
                np.asarray(t).reshape(-1, k)), out[1], ordered=True)
        return out

    jax.clear_caches()            # no trace without the callback is reused
    monkeypatch.setattr(jax.lax, "top_k", recorded)
    sched = RefScheduler(cfg, params, serve=_serve(cfg, **kw))
    chunks = {}
    real = sched._prefill_one

    def prefill_one(cache, tok, table, off, slot, fold_base):
        jax.effects_barrier()
        a = len(calls)
        out = real(cache, tok, table, off, slot, fold_base)
        jax.effects_barrier()
        chunks[(np.asarray(tok).tobytes(), int(off))] = \
            calls[a:a + cfg.num_layers]
        return out

    sched._prefill_one = prefill_one
    done = sched.run([RefRequest(i, p, MAX_NEW, temperature=0.0)
                      for i, p in enumerate(prompts)])
    monkeypatch.undo()
    return chunks, {c.rid: np.asarray(c.tokens) for c in done}


def _port(tcfg, tparams, prompts, **kw):
    """As ``_reference``, for the port's engine."""
    sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                          device="cpu")
    probe = RoutingProbe()
    chunks = {}
    real = sched._prefill_one
    K = tcfg.moe.top_k

    def prefill_one(tok, row, off, slot=0, fold_base=0):
        a = len(probe.log)
        real(tok, row, off, slot, fold_base)
        chunks[(np.asarray(tok, np.int32).tobytes(), int(off))] = [
            c.topi.reshape(-1, K).numpy()
            for c in probe.log[a:a + tcfg.num_layers]]

    sched._prefill_one = prefill_one
    with probe:
        done = sched.run([Request(i, p, MAX_NEW, temperature=0.0)
                          for i, p in enumerate(prompts)])
    return chunks, {c.rid: np.asarray(c.tokens) for c in done}


def _apart(tcfg, prompts, plain, spec):
    """Per request: (pad rows routed apart, real rows whose kept choices
    differ, greedy tokens part) between a plain and a spec engine, over
    its last prefill chunk's layers."""
    (pc, pt), (sc, st) = plain, spec
    K, g = tcfg.moe.top_k, tcfg.moe.group_size
    keep = lambda t: moe.queue(torch.from_numpy(np.array(t)).reshape(
        -1, g, K), tcfg)[1].reshape(-1, K).numpy()
    out = []
    for rid, p in enumerate(prompts):
        S = len(p)
        off = (S - 1) // 32 * 32
        tok = np.zeros(32, np.int32)
        tok[:S - off] = p[off:]
        key = (tok[None].tobytes(), off)
        pad = kept = 0
        for a, b in zip(pc[key], sc[key]):
            n, real = 32, S - off
            diff = (np.sort(a[:n], -1) != np.sort(b[:n], -1)).any(-1)
            pad += int(diff[real:].sum())
            kept += int((keep(a)[:real] != keep(b)[:real]).any(-1).sum())
        out.append((pad, kept, not np.array_equal(pt[rid], st[rid])))
    return out


def test_moe_spec_prefill_pad_rows_route_apart_in_the_reference_too(
        monkeypatch):
    """Reduced deepseek-moe (E 8, top 2, groups of 32, C 12): every
    request's pad rows route apart between the reference's plain and spec
    engines, real rows' kept choices move in most requests, and a
    request's greedy tokens part in the reference.  The port's engines do
    the same, request for request (pad and real rows within a few
    near-tie flips, the same request's tokens parting)."""
    cfg, tcfg = _configs("deepseek-moe-16b")
    params, tparams = _params(cfg, tcfg)
    prompts = _prompts(cfg)
    ref = _apart(tcfg, prompts,
                 _reference(monkeypatch, cfg, params, prompts),
                 _reference(monkeypatch, cfg, params, prompts, **SPEC))
    port = _apart(tcfg, prompts, _port(tcfg, tparams, prompts),
                  _port(tcfg, tparams, prompts, **SPEC))
    assert all(pad > 0 for pad, _, _ in ref)
    assert sum(kept > 0 for _, kept, _ in ref) >= len(prompts) // 2
    for (rp, rk, _), (pp, pk, _) in zip(ref, port):
        assert pp > 0 and abs(pp - rp) <= 4 and abs(pk - rk) <= 2
    parted = [rid for rid, (_, _, t) in enumerate(ref) if t]
    assert parted, ref
    assert all(port[rid][2] for rid in parted)


def _ref_inits(key, rank, L, I):
    """The raw inits the reference's ``rtpm`` draws for each component."""
    raw = []
    for _ in range(rank):
        key, k1 = jax.random.split(key)
        raw.append(np.asarray(jax.random.normal(k1, (L, I))))
    return torch.from_numpy(np.stack(raw))


def _clean_residual(Tc, lams, U):
    lams = np.asarray(lams, np.float64)
    U = np.asarray(U, np.float64)
    est = np.einsum("r,ar,br,cr->abc", lams, U, U, U)
    return float(np.linalg.norm(Tc - est) / np.linalg.norm(Tc))


@pytest.mark.parametrize("method", ["plain", "ts", "fcs"])
def test_sketched_rtpm_at_fig1_d2_fails_in_the_reference_too(method):
    I, R, D, L, T = (FIG1[k] for k in ("I", "R", "D", "L", "T"))
    J = 1000
    Tn, Tc = symmetric_tensor(I, R, FIG1["sigma"],
                              torch.Generator().manual_seed(0), "cpu")
    key = jax.random.PRNGKey(5)
    want_l, want_U = ref_rtpm.rtpm_decompose(
        jnp.asarray(Tn.numpy()), R, key, method=method, hash_len=J,
        n_sketches=D, n_inits=L, n_iters=T)
    hashes = None
    if method != "plain":
        hashes = mode_hashes_from_reference(
            rc.make_tensor_hashes(key, Tn.shape, [J] * 3, D), "cpu")
    got_l, got_U = rtpm.rtpm_decompose(Tn, R, method=method, n_inits=L,
                                       n_iters=T, hashes=hashes,
                                       inits=_ref_inits(key, R, L, I))
    ref_res = _clean_residual(Tc.numpy(), want_l, want_U)
    port_res = _clean_residual(Tc.numpy(), got_l.numpy(), got_U.numpy())
    if method == "plain":
        assert ref_res < 0.3 and abs(port_res - ref_res) < 1e-4
    else:
        assert ref_res > 0.9 and port_res > 0.9, (ref_res, port_res)
