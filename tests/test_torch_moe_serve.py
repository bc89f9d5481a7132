"""Port parity: request streams through the JAX package's slot scheduler
and ``repro_torch``'s for the configs this slice adds — reduced
granite-moe-3b-a800m and deepseek-moe-16b (the moe family; chunk
prefill buckets 16 and 1), a sketched-KV granite engine, qwen2.5-32b
(QKV bias, rope theta 1e6), musicgen-medium (gelu) and internvl2-2b (its
vocab cut to 300 of 512 columns here, so that a token choice that kept
the pad columns would show) — with the reference's parameters.

Scheduling is integer bookkeeping and must be equal: completion order,
allocator books, prefix-cache and fold counts.  Greedy tokens follow
tests/test_torch_serve.py: compared step by step while the reference's
teacher-forced top-1 margin stays above ``MARGIN_TOL``.  For the moe
family a routing choice whose router probabilities near-tie can flip
between the packages (tests/test_torch_moe.py), which moves the logits
of the rest of that sequence by more than the tolerance; so both
packages' routing is recorded call by call through the served stream
(``Routes``) and a request's tokens are compared only while its context
(prompt rows, cached prefix, tokens so far) routes alike."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.launch.serve import make_request_stream as ref_stream
from repro.models import layers as rly
from repro.models import transformer as rtf
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as launch
from repro_torch.launch.serve import make_request_stream
from repro_torch.models import bridge
from repro_torch.models import moe
from repro_torch.models.routing import ServedRouting
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(1)

MARGIN_TOL = 0.02
# (n_requests, n_prefixes, prefix_len, max_tail, max_new)
STREAM = (16, 2, 16, 12, 8)


def _configs(arch, **changes):
    cfg = dataclasses.replace(ref_reduced(arch), **changes)
    tcfg = dataclasses.replace(reduced_config(arch), **changes)
    return cfg, tcfg


def _params(cfg, tcfg):
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:      # the reference initialises them to zero
        rng = np.random.RandomState(11)
        attn = dict(params["blocks"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(0.5 * rng.randn(*attn[k].shape),
                                  jnp.bfloat16)
        params = {**params, "blocks": {**params["blocks"], "attn": attn}}
    return params, bridge.from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")


def _serve(cfg, **kw):
    base = dict(max_batch=3, max_seq=96, decode_chunk=4, prefill_bucket=16)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _books(sched):
    return (sched.alloc.peak_reserved, sched.alloc.reserved,
            sched.alloc.rc.tolist(), sorted(sched.alloc._free))


def _dropless(cfg):
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _margins(cfg, params, seqs):
    """The reference's teacher-forced top-1 margins (B, S) over the real
    vocab, for a padded batch of ``seqs`` (a dropless copy for the moe
    family: served decode rows never drop, and chunks rarely do)."""
    if cfg.family == "moe":
        cfg = _dropless(cfg)
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(batch)}, cfg), cfg, mode="train")
    lg = np.sort(np.asarray(rly.logits_fn(params, y, cfg))[
        ..., :cfg.vocab_size], axis=-1)
    return lg[..., -1] - lg[..., -2]


class Routes:
    """Both packages' routing through one served stream, call by call:
    the reference's ``top_k`` of every MoE layer call (recorded by a
    debug callback as its jitted chunks run), and the port's MoE calls
    with what each served (``port``, models/routing.py: pass it as the
    port engine's observer and run the engine inside ``with
    routes.port``)."""

    def __init__(self, monkeypatch, cfg, tcfg, max_batch, draft_layers=0):
        self.ref = []
        self.port = ServedRouting(tcfg.num_layers, max_batch, draft_layers)
        self.L = tcfg.num_layers
        self.C = moe.capacity(tcfg)
        E, K = cfg.moe.num_experts, cfg.moe.top_k
        top_k = jax.lax.top_k

        def ref_top_k(a, k):
            out = top_k(a, k)
            if a.shape[-1] == E and k == K:
                jax.debug.callback(
                    lambda t: self.ref.append(np.asarray(t).reshape(-1, k)),
                    out[1], ordered=True)
            return out

        jax.clear_caches()        # no trace without the callback is reused
        monkeypatch.setattr(jax.lax, "top_k", ref_top_k)

    def first_flips(self, reqs, done, prefix_len):
        """rid -> index of the first token whose context routes apart in
        the two packages.  A row whose set of choices differs changes its
        own expert output, and through the residual the KV of the later
        layers at its position:
          * a prompt row below the last layer taints the request (and,
            in the first ``prefix_len`` rows, every prefix-cache hit on
            that prefix, whose blocks hold the row); in the last layer it
            changes no KV and its logits are never read;
          * a chunk's pad row has no KV that a query reads, but in a
            chunk that dropped choices below the last layer any flip may
            move which real choices drop, which taints the request;
          * a decode row taints its request from the token it serves;
          * on a speculative engine the draft's prefill rows count as
            the target's, below the draft's last layer, and a draft
            micro-step's or verify step's row as a decode row (a flipped
            draft row may change the request's proposals); where the
            call routes more rows than an expert's C, a flip may also
            change which choices of the group drop, so a flipped row
            taints every request of the call from its first row there."""
        jax.effects_barrier()
        port = self.port.contexts()
        assert len(self.ref) == len(port)
        byrid = {r.rid: r for r in reqs}
        key = lambda rid: tuple(byrid[rid].tokens[:prefix_len])
        first = {r.rid: len(byrid[r.rid].tokens) + r.max_new for r in reqs}
        bad_prefixes = set()
        for a, (call, ctx) in zip(self.ref, port):
            K = call.topi.shape[-1]
            b = call.topi.reshape(-1, K).numpy()
            rows = np.flatnonzero((np.sort(a, -1) != np.sort(b, -1)).any(-1))
            if not len(rows):
                continue
            if ctx[0] in ("prefill", "draft prefill"):
                _, rid, off = ctx
                S = len(byrid[rid].tokens)
                pos = off + rows
                L = self.L if ctx[0] == "prefill" else self.port.draft_layers
                upper = call.layer < L - 1
                hit = pos[(pos < S) & upper]
                moved = not bool(call.keep.all()) and upper
                if moved or len(hit):
                    first[rid] = 0
                    if (off if moved else hit.min()) < prefix_len:
                        bad_prefixes.add(key(rid))
                continue
            routed = sum(p >= 0 for _, p in ctx[1])   # idle slots too
            if self.port.draft_layers and routed > self.C:
                rows = range(len(ctx[1]))
            for s in rows:
                rid, p = ctx[1][s]
                if rid is not None and p >= len(byrid[rid].tokens) - 1:
                    first[rid] = min(first[rid],
                                     p - (len(byrid[rid].tokens) - 1))
        for c in done:
            if c.prefix_hit and key(c.rid) in bad_prefixes:
                first[c.rid] = 0
        return first


def _compare_greedy(cfg, params, reqs, rdone, tdone, first=None,
                    margin=MARGIN_TOL):
    """Greedy tokens equal while the reference's margin exceeds
    ``margin`` (and, with ``first``, before the request's context routes
    apart); returns the number compared."""
    byrid = {r.rid: r for r in reqs}
    greedy = [c for c in rdone if byrid[c.rid].temperature == 0.0]
    tmap = {c.rid: c for c in tdone}
    seqs = [np.concatenate([byrid[c.rid].tokens, c.tokens]) for c in greedy]
    margins = _margins(cfg, params, seqs)
    compared = 0
    for i, c in enumerate(greedy):
        S = len(byrid[c.rid].tokens)
        ok = margins[i, S - 1:S - 1 + len(c.tokens)] >= margin
        n = len(ok) if ok.all() else int(np.argmin(ok))
        if first is not None:
            n = min(n, first[c.rid])
        np.testing.assert_array_equal(tmap[c.rid].tokens[:n], c.tokens[:n],
                                      err_msg=f"rid {c.rid}")
        compared += n
    return compared


def _run_both(cfg, params, tcfg, tparams, reqs, treqs, routes=None, **kw):
    rs = RefScheduler(cfg, params, serve=_serve(cfg, **kw))
    if routes is None:
        ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                           device="cpu")
        return rs, ts, rs.run(list(reqs)), ts.run(list(treqs))
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                       device="cpu", obs=routes.port)
    rdone = rs.run(list(reqs))
    with routes.port:
        tdone = ts.run(list(treqs))
    return rs, ts, rdone, tdone


def _assert_schedule_equal(rs, ts, rdone, tdone):
    assert [c.rid for c in rdone] == [c.rid for c in tdone]
    assert [c.prefix_hit for c in rdone] == [c.prefix_hit for c in tdone]
    assert _books(ts) == _books(rs)
    ref, got = rs.stats(), ts.stats()
    # compilations: XLA's in the reference, CUDA graph captures (none on
    # the CPU) in the port
    assert (ref.decode_compilations, got.decode_compilations) == (1, 0)
    for f in dataclasses.fields(got):
        if f.name in ("decode_compilations", "prefill_compilations"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m",
                                        "deepseek-moe-16b"])
def moe_model(request):
    cfg, tcfg = _configs(request.param)
    return (cfg, tcfg) + _params(cfg, tcfg)


@pytest.mark.parametrize("bucket", [16, 1])
def test_moe_stream_matches_reference(monkeypatch, moe_model, bucket):
    """A stream with shared prefixes and a sampled quarter: bucket 16
    pads tail chunks with token-0 rows, which route and take capacity in
    both packages; bucket 1 feeds exact-length chunks."""
    cfg, tcfg, params, tparams = moe_model
    reqs = ref_stream(cfg, np.random.RandomState(5), *STREAM,
                      sampled_frac=0.25)
    treqs = make_request_stream(tcfg, np.random.RandomState(5), *STREAM,
                                sampled_frac=0.25)
    routes = Routes(monkeypatch, cfg, tcfg, _serve(tcfg).max_batch)
    rs, ts, rdone, tdone = _run_both(cfg, params, tcfg, tparams, reqs,
                                     treqs, routes, prefill_bucket=bucket)
    first = routes.first_flips(reqs, tdone, STREAM[2])
    monkeypatch.undo()
    _assert_schedule_equal(rs, ts, rdone, tdone)
    assert ts.stats().prefix_hits > 0
    assert all(len(c.tokens) == STREAM[4] for c in tdone)
    n = _compare_greedy(cfg, params, reqs, rdone, tdone, first)
    # 54-68 of the 104 greedy tokens at this size
    assert n >= 32, (n, first)


def test_served_routing_forces_a_dropless_recompute():
    """models/routing.py's ServedRouting, attached to a port engine as its
    observer, files every routed row of a stream (prefix hits included)
    under its request and position: a full-sequence recompute of each
    greedy request on a dropless copy, forced onto those experts, ranks
    every served greedy token first above the margin, and its own
    routing differs from the forcing only at near-ties.  Chunks of 8
    rows and steps of 3 rows never fill an expert's 12 rows, so the
    engine drops nothing and the dropless recompute is its function."""
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import RoutingProbe
    _, tcfg = _configs("granite-moe-3b-a800m")
    tparams = tf.init_params(tcfg, seed=3, device="cpu")
    serve = _serve(tcfg, prefill_bucket=8, admit_threshold=1)
    assert max(serve.prefill_bucket, serve.max_batch) <= moe.capacity(tcfg)
    treqs = make_request_stream(tcfg, np.random.RandomState(5), *STREAM)
    served = ServedRouting(tcfg.num_layers, serve.max_batch)
    ts = SlotScheduler(tcfg, tparams, serve=serve, device="cpu", obs=served)
    with served:
        done = ts.run(list(treqs))
    assert ts.stats().prefix_hits > 0
    assert all(bool(c.keep.all()) for c in served.calls)
    prompts = {r.rid: r.tokens for r in treqs}
    free = _dropless(tcfg)
    compared = 0
    for c in done:
        toks = np.concatenate([prompts[c.rid], c.tokens[:-1]])
        S = len(prompts[c.rid])
        with RoutingProbe(served.forcing_of(toks, c.rid, prompts, free,
                                            "cpu")) as r, torch.no_grad():
            y, _ = tf.forward(tparams, tf.embed_inputs(
                tparams, torch.as_tensor(toks)[None]), free)
            lg = ly.logits_fn(tparams, y, free)[0, S - 1:, :free.vocab_size]
        assert r.worst < 0.02, r.worst
        srt = lg.sort(-1).values
        sure = (srt[:, -1] - srt[:, -2]) > MARGIN_TOL
        np.testing.assert_array_equal(lg.argmax(-1).numpy()[sure.numpy()],
                                      np.asarray(c.tokens)[sure.numpy()])
        compared += int(sure.sum())
    assert compared >= 3 * len(done), compared


# (arch, config changes): the dense-stack configs this slice adds
DENSE = {"qwen2.5-32b": {}, "musicgen-medium": {},
         "internvl2-2b": {"vocab_size": 300}}


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_greedy_stream_matches_reference(arch):
    cfg, tcfg = _configs(arch, **DENSE[arch])
    params, tparams = _params(cfg, tcfg)
    assert tcfg.padded_vocab == params["embed"].shape[0]
    reqs = ref_stream(cfg, np.random.RandomState(6), *STREAM)
    treqs = make_request_stream(tcfg, np.random.RandomState(6), *STREAM)
    rs, ts, rdone, tdone = _run_both(cfg, params, tcfg, tparams, reqs,
                                     treqs)
    _assert_schedule_equal(rs, ts, rdone, tdone)
    assert all(((0 <= c.tokens) & (c.tokens < tcfg.vocab_size)).all()
               for c in tdone)
    n = _compare_greedy(cfg, params, reqs, rdone, tdone)
    assert n >= 3 * len(reqs), n


# every dense stack speculates, qwen2.5-32b's attention biases included
# (the moe family's streams: tests/test_torch_moe_spec.py)
SPEC_DENSE = {"minitron-4b": {}, "musicgen-medium": {},
              "internvl2-2b": {"vocab_size": 300}, "qwen2.5-32b": {}}


@pytest.mark.parametrize("arch", sorted(SPEC_DENSE))
def test_spec_stream_matches_reference(arch):
    """A speculative stream (spec_k 3, a depth-1 truncated draft made
    exact: the target's upper layers zeroed, so every proposal is
    accepted in both packages) through both packages' engines, as
    tests/test_torch_speculative.py holds gemma-2b's: completion order,
    books and every stat, speculative counters included, equal; greedy
    tokens equal above the margin and inside the real vocab."""
    cfg, tcfg = _configs(arch, **SPEC_DENSE[arch])
    params, _ = _params(cfg, tcfg)
    blocks = dict(params["blocks"])
    blocks["attn"] = dict(blocks["attn"], wo=blocks["attn"]["wo"].at[
        1:].set(0))
    blocks["ffn"] = dict(blocks["ffn"], w_down=blocks["ffn"][
        "w_down"].at[1:].set(0))
    params = dict(params, blocks=blocks)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    reqs = ref_stream(cfg, np.random.RandomState(6), *STREAM,
                      sampled_frac=0.25)
    treqs = make_request_stream(tcfg, np.random.RandomState(6), *STREAM,
                                sampled_frac=0.25)
    rs, ts, rdone, tdone = _run_both(cfg, params, tcfg, tparams, reqs,
                                     treqs, spec_k=3, draft_depth=1)
    _assert_schedule_equal(rs, ts, rdone, tdone)
    st = ts.stats()
    assert st.spec_rounds > 0 and st.acceptance_rate == 1.0
    assert all(((0 <= c.tokens) & (c.tokens < tcfg.vocab_size)).all()
               for c in tdone)
    n = _compare_greedy(cfg, params, reqs, rdone, tdone)
    assert n >= 2 * len(reqs), n


def _reference_waiting(cfg, params, serve):
    """The reference's scheduler, made to wait for its prefill and fold
    computations (see tests/test_torch_kv_sketch_serve.py: it edits numpy
    block-table rows that a queued computation may still read)."""
    rs = RefScheduler(cfg, params, serve=serve)
    for name in ("_prefill_chunk", "_fold_fn"):
        fn = getattr(rs, name)

        def waiting(*a, _fn=fn):
            return jax.block_until_ready(_fn(*a))

        waiting._cache_size = fn._cache_size
        setattr(rs, name, waiting)
    return rs


def test_sketched_moe_stream_matches_reference():
    """Sketched KV on the moe family: a prompt that folds beside one that
    opts out.  Books and fold counts equal the reference's, and the exact
    request decodes as on a sketch-free engine, bitwise."""
    cfg, tcfg = _configs("granite-moe-3b-a800m")
    params, tparams = _params(cfg, tcfg)
    bs = cfg.serve.kv_block_size
    kw = dict(max_batch=2, max_seq=256, num_kv_blocks=24,
              kv_sketch_window=2 * bs)
    rng = np.random.RandomState(9)
    pl, pe = (rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
              for n in (140, 17))
    rs = _reference_waiting(cfg, params, _serve(cfg, **kw))
    rdone = rs.run([RefRequest(rid=0, tokens=pl, max_new=4),
                    RefRequest(rid=1, tokens=pe, max_new=4,
                               kv_sketch=False)])
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                       device="cpu")
    got = {c.rid: list(c.tokens) for c in ts.run(
        [Request(rid=0, tokens=pl, max_new=4),
         Request(rid=1, tokens=pe, max_new=4, kv_sketch=False)])}
    assert [c.rid for c in ts.completed] == [c.rid for c in rdone]
    assert ts.fold_rows_total == rs.fold_rows_total > 0
    assert _books(ts) == _books(rs)
    assert all(len(v) == 4 for v in got.values())
    plain = SlotScheduler(tcfg, tparams, serve=_serve(
        tcfg, max_batch=1, max_seq=256, num_kv_blocks=24), device="cpu")
    ref = {c.rid: list(c.tokens) for c in plain.run(
        [Request(rid=1, tokens=pe, max_new=4)])}
    assert got[1] == ref[1]


def test_launcher_serves_a_moe_arch(capsys):
    launch.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                 "--requests", "4", "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "statuses: {'ok': 4}" in out
    # a moe arch and one with attention biases speculate
    for arch in ("granite-moe-3b-a800m", "qwen2.5-32b"):
        launch.main(["--device", "cpu", "--arch", arch, "--spec-k", "2",
                     "--draft-sketch-ratio", "2", "--requests", "2",
                     "--max-new", "4", "--max-batch", "2"])
        out = capsys.readouterr().out
        assert "statuses: {'ok': 2}" in out
        assert "speculative: acceptance=" in out
        assert "sketched head: True" in out
