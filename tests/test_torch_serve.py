"""Port parity: the same request stream through the JAX package's slot
scheduler and ``repro_torch``'s, on reduced gemma-2b with the
reference's parameters.

Scheduling is integer bookkeeping and must be equal: completion order,
allocator books and prefix-cache hit / admit / evict counts.  Greedy
tokens are compared step by step up to the first step at which the
reference's teacher-forced top-1 margin falls below ``MARGIN_TOL``;
past that a near-tie may flip and the contexts diverge.  MARGIN_TOL is
twice the largest decode-logit gap between the packages measured at this
size (~0.01, tests/test_torch_model.py), so a margin above it cannot
flip."""
import asyncio
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
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.configs.registry import reduced_config
from repro_torch.launch.serve import make_request_stream
from repro_torch.models import bridge
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

MARGIN_TOL = 0.02
# (n_requests, n_prefixes, prefix_len, max_tail, max_new)
STREAM = (20, 3, 32, 24, 10)


def _serve(cfg, **kw):
    return dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                               decode_chunk=4, prefill_bucket=16, **kw)


@pytest.fixture(scope="module")
def served():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    rreqs = ref_stream(cfg, np.random.RandomState(5), *STREAM,
                       sampled_frac=0.25)
    treqs = make_request_stream(tcfg, np.random.RandomState(5), *STREAM,
                                sampled_frac=0.25)
    rs = RefScheduler(cfg, params, serve=_serve(cfg))
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams,
                rreqs=rreqs, treqs=treqs, rs=rs, ts=ts,
                rdone=rs.run(list(rreqs)), tdone=ts.run(list(treqs)))


def test_stream_and_schedule_equal_reference(served):
    rr, tr = served["rreqs"], served["treqs"]
    for a, b in zip(rr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.max_new, a.temperature, a.top_k, a.seed) == \
            (b.max_new, b.temperature, b.top_k, b.seed)
    assert [c.rid for c in served["rdone"]] == \
        [c.rid for c in served["tdone"]]
    assert [c.prefix_hit for c in served["rdone"]] == \
        [c.prefix_hit for c in served["tdone"]]
    ref, got = served["rs"].stats(), served["ts"].stats()
    # decode_ and prefill_compilations count XLA compilations in the
    # reference and CUDA graph captures in the port, which runs eagerly on
    # the CPU
    assert (ref.decode_compilations, got.decode_compilations) == (1, 0)
    assert (ref.prefill_compilations, got.prefill_compilations) == (1, 0)
    for f in dataclasses.fields(got):
        if f.name in ("decode_compilations", "prefill_compilations"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.prefix_hits > 0 and got.prefix_admitted > 0


def test_greedy_tokens_equal_reference_above_margin(served):
    cfg, params = served["cfg"], served["params"]
    rr = served["rreqs"]
    greedy = [c for c in served["rdone"] if rr[c.rid].temperature == 0.0]
    tdone = {c.rid: c for c in served["tdone"]}
    # teacher-forced margins: one padded batch (causal, so trailing pad
    # leaves earlier positions unchanged)
    seqs = [np.concatenate([rr[c.rid].tokens, c.tokens]) for c in greedy]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(batch)}, cfg), cfg, mode="train")
    lg = np.asarray(rly.logits_fn(params, y, cfg))[..., :cfg.vocab_size]
    compared = 0
    for i, c in enumerate(greedy):
        S = len(rr[c.rid].tokens)
        srt = np.sort(lg[i, S - 1:S - 1 + len(c.tokens)], axis=-1)
        margin = srt[:, -1] - srt[:, -2]
        n = int(np.argmax(margin < MARGIN_TOL)) if (
            margin < MARGIN_TOL).any() else len(margin)
        np.testing.assert_array_equal(tdone[c.rid].tokens[:n], c.tokens[:n],
                                      err_msg=f"rid {c.rid}")
        compared += n
    assert compared >= 24, compared


def test_sampled_streams_reproducible_by_seed(served):
    tcfg, tparams = served["tcfg"], served["tparams"]
    reqs = make_request_stream(tcfg, np.random.RandomState(8), 6, 2, 16, 8,
                               6, sampled_frac=1.0)

    def run(requests):
        s = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
        return {c.rid: c.tokens for c in s.run(requests)}

    a, b = run(list(reqs)), run(list(reqs))
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    other = run([dataclasses.replace(r, seed=r.seed + 1) for r in reqs])
    assert any(not np.array_equal(a[r], other[r]) for r in a)


def test_generate_is_the_streamed_path(served):
    """ServeEngine.generate (the batched facade over the async pump)
    returns what the scheduler serves for the same greedy prompts."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    prompts = np.stack([r.tokens[:24] for r in served["treqs"][:3]])
    eng = ServeEngine(tcfg, tparams, max_seq=64, device="cpu")
    res = eng.generate(prompts, max_new=5)
    s = SlotScheduler(tcfg, tparams, serve=dataclasses.replace(
        tcfg.serve, max_batch=3, max_seq=64), device="cpu")
    done = {c.rid: c.tokens for c in s.run(
        [Request(rid=i, tokens=p, max_new=5)
         for i, p in enumerate(prompts)])}
    for i in range(3):
        np.testing.assert_array_equal(res.tokens[i].numpy(), done[i])


def test_cancel_and_deadline_leave_no_leaked_blocks(served):
    tcfg, tparams = served["tcfg"], served["tparams"]
    reqs = make_request_stream(tcfg, np.random.RandomState(9), 8, 2, 16, 8,
                               12)
    front = AsyncServeEngine(tcfg, tparams, serve=_serve(tcfg),
                             device="cpu")

    async def go():
        hs = [await front.submit(r.tokens, max_new=r.max_new, rid=r.rid,
                                 deadline_s=(1e-9 if r.rid == 5 else 0))
              for r in reqs]

        async def consume(h):
            async for n, _ in _aenumerate(h.stream()):
                if h.rid in (1, 6) and n == 3:
                    h.cancel()
            return h.completion

        return await asyncio.gather(*(consume(h) for h in hs))

    done = {c.rid: c for c in asyncio.run(go())}
    assert len(done) == len(reqs)
    assert done[1].status == done[6].status == "cancelled"
    assert done[5].status == "expired"
    assert all(done[r].status == "ok" and len(done[r].tokens) == 12
               for r in (0, 2, 3, 4, 7))
    sched = front.scheduler
    pc = sched.prefix_cache
    # every reserved block is a prefix-cache entry's; evicting them all
    # returns the pool to empty
    assert sched.alloc.reserved == pc.held_blocks()
    while pc.evict_one():
        pass
    assert sched.alloc.reserved == 0
    assert int(sched.alloc.rc.sum()) == 0


async def _aenumerate(it):
    n = 0
    async for x in it:
        n += 1
        yield n, x


def test_not_ported_options_raise(served):
    # the observer hooks are ported (tests/test_torch_obs.py): attaching
    # none is accepted.  Every family serves now (the recurrent ones:
    # tests/test_torch_recurrent_serve.py) and trains
    # (tests/test_torch_train_families.py); a family no package has is
    # refused; speculation on the moe family is ported (ROADMAP Queue 1
    # #20), so a moe spec engine builds
    served["ts"].set_observer(None)
    assert served["ts"].obs is None
    with pytest.raises(ValueError, match="unknown family"):
        SlotScheduler(dataclasses.replace(served["tcfg"], family="rnn"),
                      served["tparams"], serve=_serve(served["tcfg"]),
                      device="cpu")
    from repro_torch.models import transformer as tf
    mcfg = reduced_config("granite-moe-3b-a800m")
    sched = SlotScheduler(mcfg, tf.init_params(mcfg, seed=0, device="cpu"),
                          serve=dataclasses.replace(_serve(mcfg), spec_k=2),
                          device="cpu")
    assert sched.spec_max == 2


def _drive(capsys, *args):
    launch_args = ["--device", "cpu", "--requests", "6", "--max-new", "6",
                   "--max-batch", "2", *args]
    from repro_torch.launch import serve as launch
    launch.main(launch_args)
    return capsys.readouterr().out


# the launcher's options beside the reference's (src/repro/launch/
# serve.py): each run on the CPU drive, with what it must show
LAUNCH_OPTIONS = {
    "admit_threshold": (["--admit-threshold", "100"], "admitted=0,"),
    "temperature_top_k": (["--sampled-frac", "1", "--temperature", "1.5",
                           "--top-k", "3"], "statuses: {'ok': 6}"),
    "paged_kernels_off": (["--paged-kernels", "off"],
                          "plain version (--paged-kernels off)"),
    "deadline_s": (["--deadline-s", "1e-9"], "'expired'"),
    "priority_frac": (["--priority-frac", "1", "--arrival-rate", "1000"],
                      "statuses: {'ok': 6}"),
}


@pytest.mark.parametrize("name", sorted(LAUNCH_OPTIONS))
def test_launcher_options(capsys, name):
    args, shows = LAUNCH_OPTIONS[name]
    assert shows in _drive(capsys, *args)


def test_launcher_paged_kernels_on_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ValueError, match="CUDA"):
        _drive(capsys, "--paged-kernels", "on")


def test_serve_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(reduced_config("gemma-2b"), None)
