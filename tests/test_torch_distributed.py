"""Multi-process parity of the port's launch tooling on the CPU: gloo
process groups initialised through a ``FileStore`` in ``tmp_path`` (no
TCP port), one process per rank.

* A train step sharded on a 2 x 2 (data, model) mesh — FSDP parameter
  placements (the byte threshold lowered to 0 so the reduced configs'
  leaves shard), batch over data, sequence over model (fsdp_seq) —
  equals the unsharded step (loss and every gradient) and the
  reference's loss.  The reduced zamba2 case runs its SSD chunk
  recurrence in the two-level order (``ctx_shards`` 2), in f32 (the
  port's activations follow the weights' dtype), where the two orders'
  sums part only by f32 rounding; yi-9b runs in bf16.  The reduced
  granite-moe case routes each rank's groups on its own rows (its
  experts gathered, the aux loss summed across ranks), in f32.
* Decode steps at the decode TP placements on a 2 x 2 mesh (the paged
  pool and zamba2's dense cache split over slots and keys) equal the
  unsharded steps.
* Two "pod" ranks run ``make_podwise_compressed_step`` on halves of a
  batch: the estimate equals the reference's compressed step's on the
  whole batch at the same hashes, and the sketch bytes all-reduced are
  the sum of J~ x 4 B.
* A checkpoint saved by one process and restored onto a two-rank mesh
  is bitwise the saved state.
* Sketched AdamW steps DTensor params on a (1, 1) mesh bitwise as the
  unsharded step; sketched AdamW and Adagrad on (2, 1) and (2, 2) meshes
  keep their tables column-sharded and step within stated bounds of the
  unsharded step; a strided piece's plain version is bitwise per-row
  contiguous pieces.

The worker functions run in spawned processes that import this module,
so JAX is imported inside the tests only.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

LOSS_TOL = 2e-3          # relative, sharded vs unsharded loss (bf16)
REF_LOSS_TOL = 2e-2      # relative, against the reference's loss
GRAD_TOL = {"bf16": 0.03, "f32": 1e-3}  # of max|g|, sharded vs unsharded
POD_TOL = 0.06           # of max|estimate|, as test_torch_grad_compress


def _entry(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp, fn, *args):
    mp.start_processes(_entry, args=(world, str(tmp), fn, args),
                       nprocs=world, start_method="spawn", join=True)


def _cfg(arch):
    from repro_torch.configs.registry import reduced_config
    return reduced_config(arch)


# ---------------------------------------------------------------------------
# Sharded train step on a 2 x 2 mesh
# ---------------------------------------------------------------------------


def _sharded_step(rank, world, tmp, arch):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import logical_rules
    from repro_torch.models.transformer import param_leaves

    cfg = _cfg(arch)
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules, strategy = SH.make_rules(cfg, "train", False, False, 4)
    rules["ctx_shards"] = 2                 # the mesh's model axis
    SH._FSDP_MIN_BYTES = 0                  # shard the reduced leaves too
    specs = SH.build_param_pspecs(cfg, state["params"], rules, strategy)
    params = SH.distribute(state["params"], specs, mesh)
    batch = SH.distribute(state["batch"], {
        k: (rules["batch"], None) for k in state["batch"]}, mesh)
    with logical_rules(rules), implicit_replication():
        loss, grads = M.make_train_step(cfg)(params, batch)
    full = [[g.full_tensor() for g in pieces]
            for _, pieces in param_leaves(grads)]
    sharded = sum(1 for _, ps in param_leaves(params) for p in ps
                  if any(not pl.is_replicate() for pl in p.placements))
    if rank == 0:
        torch.save({"loss": loss.full_tensor(), "grads": full,
                    "sharded": sharded}, os.path.join(tmp, "out.pt"))


@pytest.mark.parametrize("arch,prec", [("yi-9b", "bf16"),
                                       ("zamba2-2.7b", "f32"),
                                       ("granite-moe-3b-a800m", "f32")])
def test_sharded_train_step_matches_unsharded_and_reference(arch, prec,
                                                            tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import reduced_config as ref_reduced
    from repro.models import transformer as rtf
    from repro_torch.models import bridge
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import param_leaves

    cfg, tcfg = ref_reduced(arch), _cfg(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    if prec == "f32":
        tparams = tf.tree_map(lambda t: t.float(), tparams)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 65))
    batch = {"tokens": toks[:, :64], "labels": toks[:, 1:]}
    ref_loss = float(rtf.loss_fn(params, {k: jnp.asarray(v, jnp.int32)
                                          for k, v in batch.items()}, cfg))
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    torch.save({"params": tparams, "batch": tbatch}, tmp_path / "in.pt")
    loss, grads = M.make_train_step(tcfg)(tparams, tbatch)
    _spawn(4, tmp_path, _sharded_step, arch)
    out = torch.load(tmp_path / "out.pt")
    assert out["sharded"] > 0
    assert abs(float(out["loss"]) - float(loss)) <= LOSS_TOL * abs(
        float(loss))
    assert abs(float(out["loss"]) - ref_loss) <= REF_LOSS_TOL * abs(ref_loss)
    for (name, want), got in zip(param_leaves(grads), out["grads"]):
        for w, g in zip(want, got):
            w, g = w.float(), g.float()
            scale = float(w.abs().max()) or 1.0
            err = float((g - w).abs().max())
            assert err <= GRAD_TOL[prec] * scale, (name, err, scale)


def test_two_level_ssd_scan_matches_the_loop():
    """The SSD chunk recurrence in the reference's two-level order (a loop
    in each of ns context shards, then the shards' prefix) equals the
    sequential loop within the port's f32 SSD tolerance."""
    from repro_torch.models import ssm
    from repro_torch.models.sharding import logical_rules

    g = torch.Generator().manual_seed(0)
    dec = torch.rand((2, 8, 3), generator=g) * 0.9 + 0.05
    s_f = torch.randn((2, 8, 3, 4, 5), generator=g)
    init = torch.randn((2, 3, 4, 5), generator=g)
    want_in, want_fin = ssm._state_scan(dec, s_f, init)
    for ns in (2, 4):
        with logical_rules({"ctx_shards": ns}):
            got_in, got_fin = ssm._state_scan(dec, s_f, init)
        for a, b in ((got_in, want_in), (got_fin, want_fin)):
            assert float((a - b).abs().max()) <= 2e-4 * float(
                b.abs().max())


# ---------------------------------------------------------------------------
# Sharded decode (split-KV) on a 2 x 2 mesh
# ---------------------------------------------------------------------------


def _sharded_decode(rank, world, tmp, arch):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import logical_rules

    cfg = _cfg(arch)
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules, _ = SH.make_rules(cfg, "decode", False, False)
    params = SH.distribute(state["params"], SH.build_param_pspecs(
        cfg, state["params"], rules, "tp"), mesh)
    cache = SH.distribute(state["cache"], SH.cache_pspecs(
        cfg, state["cache"], rules), mesh)
    step = M.make_serve_step(cfg)
    logits = []
    with logical_rules(rules), implicit_replication():
        for tok, idx in zip(state["tokens"], state["index"]):
            logits.append(step(params, cache, tok, idx)[0].full_tensor())
    full = {k: {kk: vv.full_tensor() for kk, vv in v.items()}
            if isinstance(v, dict) else v.full_tensor()
            for k, v in cache.items()}
    if rank == 0:
        torch.save({"logits": logits, "cache": full},
                   os.path.join(tmp, "out.pt"))


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b"])
def test_sharded_decode_matches_unsharded(arch, tmp_path):
    """Decode steps at the decode TP placements on a 2 x 2 mesh, the
    cache split over slots (data) and keys (model): gemma's paged pool
    (each rank writes the rows of the blocks it holds and the ranks merge
    their softmax statistics) and zamba2's dense shared-attention cache,
    in f32, against the unsharded steps."""
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf

    cfg = _cfg(arch)
    params = tf.tree_map(lambda t: t.float(),
                         tf.init_params(cfg, seed=4, device="cpu"))
    rules, _ = SH.make_rules(cfg, "decode", False, False)
    cache = M.init_slot_cache(cfg, 4, 64, "cpu",
                              SH.cache_split(rules, {"data": 2, "model": 2}))
    cache = tf.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        cache)
    g = torch.Generator().manual_seed(5)
    tokens = [torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
              for _ in range(3)]
    start = torch.tensor([5, 9, 17, 30], dtype=torch.int32)
    index = [start + i for i in range(3)]
    torch.save({"params": params, "cache": cache, "tokens": tokens,
                "index": index}, tmp_path / "in.pt")
    step = M.make_serve_step(cfg)
    want = [step(params, cache, t, i)[0] for t, i in zip(tokens, index)]
    _spawn(4, tmp_path, _sharded_decode, arch)
    out = torch.load(tmp_path / "out.pt")
    for a, b in zip(out["logits"], want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    got = tf.tree_map(lambda t: t, out["cache"])
    for k, v in cache.items():
        for kk, w in (v.items() if isinstance(v, dict) else [(k, v)]):
            gg = got[k][kk] if isinstance(v, dict) else got[k]
            if w.is_floating_point():
                assert float((gg - w).abs().max()) <= 1e-4 * max(
                    float(w.abs().max()), 1.0), (k, kk)
            else:
                assert torch.equal(gg, w), (k, kk)


# ---------------------------------------------------------------------------
# Sharded two-span (sketched) decode, verify and chunk on a 2 x 2 mesh
# ---------------------------------------------------------------------------

SK_SLOTS, SK_SEQ, SK_ROWS, SK_RATIO, SK_PROMPT = 4, 128, 3, 4, 48


def _sketched_steps(cfg, params, cache, state, fold, record):
    """The checked sequence, the same on the unsharded and the sharded
    cache: a fold, a chunk of 8 tokens a slot, two decode steps, a second
    fold and a verify step at spec_k 2 (3 tokens a slot); ``record(what,
    tensor)`` sees every logits tensor and each fold's tail."""
    from repro_torch.models import layers as ly
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    fb = state["fold_base"].clone()
    step = M.make_serve_step(cfg)
    for i, (ff_len, toks, kind) in enumerate(state["script"]):
        idx = state["index"][i]
        if kind.startswith("slot"):
            # one slot's fold-through (the whole stacked tail, the other
            # slots folding nothing) and its prefill chunk, which reads
            # its one-slot tail view
            b = int(kind[4:])
            fold(cache, fb, ff_len)
            fb = fb + ff_len
            record(f"tail{i}", cache["tail"])
            one = {"kv": cache["kv"], "tail": cache["tail"][:, :, b:b + 1],
                   "tables": cache["tables"][b:b + 1]}
            tf.prefill_chunk(params, {"kv": cache["kv"]}, toks,
                             cache["tables"][b], idx[b:b + 1], cfg,
                             sketch=M.tail_sketch(cfg, one, fb[b:b + 1]))
            continue
        if ff_len is not None:
            fold(cache, fb, ff_len)
            fb = fb + ff_len
            record(f"tail{i}", cache["tail"])
        sk = M.tail_sketch(cfg, cache, fb)
        if kind == "chunk":
            y, _ = tf.forward(params, tf.embed_inputs(params, toks), cfg,
                              mode="chunk", cache={"kv": cache["kv"]},
                              index=idx, tables=cache["tables"], sketch=sk)
            record(f"logits{i}", ly.logits_fn(params, y, cfg))
        elif kind == "decode":
            record(f"logits{i}", step(params, cache, toks, idx, fb)[0])
        else:
            record(f"logits{i}", tf.verify_step(
                params, {"kv": cache["kv"]}, toks, idx, cfg,
                cache["tables"], sketch=sk)[0])
    record("fold_base", fb)


def _sketched_rank(rank, world, tmp, long_context):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import logical_rules
    from repro_torch.serve import kv_sketch as kvs

    cfg = _cfg("gemma-2b")
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules, _ = SH.make_rules(cfg, "decode", long_context, False)
    params = SH.distribute(state["params"], SH.build_param_pspecs(
        cfg, state["params"], rules, "tp"), mesh)
    cache = SH.distribute(state["cache"], SH.cache_pspecs(
        cfg, state["cache"], rules), mesh)
    coeffs = kvs.tail_coeffs(cfg.serve)
    got = {}

    def fold(c, fb, n):
        kvs.fold_pool(c["kv"], c["tail"], c["tables"], fb, n, coeffs,
                      state["fold_cap"])

    def record(what, t):
        got[what] = (t.full_tensor() if hasattr(t, "full_tensor")
                     else t).clone()

    with logical_rules(rules), implicit_replication():
        _sketched_steps(cfg, params, cache, state, fold, record)
    got["pool"] = {k: v.full_tensor() for k, v in cache["kv"].items()}
    got["tables"] = cache["tables"].full_tensor()
    got["local_tail"] = tuple(cache["tail"].to_local().shape)
    if rank == 0:
        torch.save(got, os.path.join(tmp, "out.pt"))


@pytest.mark.parametrize("long_context", [False, True])
def test_sharded_sketched_steps_match_unsharded(long_context, tmp_path):
    """Reduced gemma-2b in f32 with FCS tail tables on a 2 x 2 (data,
    model) mesh at the decode placements: the pool split by blocks and
    the tails by slots (data) and bucket columns (model), or, under the
    long-context rules, the slots unsplit and the blocks and columns
    over both axes, where one slot's fold-through and prefill chunk run
    on its one-slot tail view.  Each fold of aged rows
    (``kv_sketch.fold_pool``) is bitwise the unsharded fold; the chunk,
    decode and verify (spec_k 2) logits of the two-span attention are
    within 1e-4 x max|logit| of the unsharded steps', with slots that
    folded nothing, some, and more; the pool rows and tails at the end
    within 1e-4 x max, tables and fold_base bitwise."""
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_sketch as kvs

    cfg = _cfg("gemma-2b")
    params = tf.tree_map(lambda t: t.float(),
                         tf.init_params(cfg, seed=6, device="cpu"))
    rules, _ = SH.make_rules(cfg, "decode", long_context, False)
    C = kvs.tail_cols(SK_SEQ, SK_RATIO)
    cache = M.init_slot_cache(cfg, SK_SLOTS, SK_SEQ, "cpu",
                              SH.cache_split(rules, {"data": 2, "model": 2}),
                              tail=(SK_ROWS, C))
    cache = tf.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        cache)
    g = torch.Generator().manual_seed(7)
    tok = lambda S: torch.randint(0, cfg.vocab_size, (SK_SLOTS, S),
                                  generator=g)
    # the prompt, unsharded, then the tails' first folds: slot 0 keeps
    # its whole context exact
    start = torch.zeros((SK_SLOTS,), dtype=torch.int32)
    tf.forward(params, tf.embed_inputs(params, tok(SK_PROMPT)), cfg,
               mode="chunk", cache={"kv": cache["kv"]}, index=start,
               tables=cache["tables"])
    coeffs = kvs.tail_coeffs(cfg.serve)
    cap = 16
    fb = torch.zeros((SK_SLOTS,), dtype=torch.int32)
    for n in ([0, 16, 16, 16], [0, 0, 16, 16]):
        n = torch.tensor(n, dtype=torch.int32)
        kvs.fold_pool(cache["kv"], cache["tail"], cache["tables"], fb, n,
                      coeffs, cap)
        fb = fb + n
    i32 = lambda v: torch.full((SK_SLOTS,), v, dtype=torch.int32)
    state = {"fold_base": fb, "fold_cap": cap, "script": [
        (torch.tensor([0, 16, 0, 16], dtype=torch.int32), tok(8), "chunk"),
        (None, tok(1), "decode"), (None, tok(1), "decode"),
        (torch.tensor([16, 16, 16, 0], dtype=torch.int32), tok(3),
         "verify")],
        "index": [i32(SK_PROMPT), i32(SK_PROMPT + 8), i32(SK_PROMPT + 9),
                  i32(SK_PROMPT + 10)]}
    if long_context:
        # slot 0's next prompt rows (every fold takes rows written before
        # the steps, so the folds compare bitwise)
        state["script"].append((torch.tensor([16, 0, 0, 0],
                                             dtype=torch.int32),
                                tok(8)[:1], "slot0"))
        state["index"].append(i32(SK_PROMPT + 13))
    torch.save({"params": params, "cache": cache, **state},
               tmp_path / "in.pt")
    want = {}

    def fold(c, fbb, n):
        kvs.fold_pool(c["kv"], c["tail"], c["tables"], fbb, n, coeffs, cap)

    _sketched_steps(cfg, params, cache, state, fold,
                    lambda w, t: want.__setitem__(w, t.clone()))
    assert want["fold_base"].tolist() == ([32, 48, 48, 48] if long_context
                                          else [16, 48, 48, 48])
    _spawn(4, tmp_path, _sketched_rank, long_context)
    got = torch.load(tmp_path / "out.pt")
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    split = (SK_SLOTS, C // 4) if long_context else (SK_SLOTS // 2, C // 2)
    assert got["local_tail"] == (2, L, split[0], SK_ROWS, split[1], K, hd)
    for k, w in want.items():
        if k.startswith("tail"):
            assert torch.equal(got[k], w), k
        elif k == "fold_base":
            assert torch.equal(got[k], w)
        else:
            assert float((got[k] - w).abs().max()) <= 1e-4 * float(
                w.abs().max()), k
    for k in ("k", "v"):
        w = cache["kv"][k]
        assert float((got["pool"][k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k
    assert torch.equal(got["tables"], cache["tables"])


SK_REF_TOL = 0.03        # of max|logit|, tests/test_torch_kv_sketch.py


@pytest.mark.parametrize("long_context", [False, True])
def test_sharded_sketched_steps_match_reference(long_context, tmp_path):
    """The sharded two-span decode and verify (spec_k 2) steps against the
    reference's sketched steps: the reference's reduced gemma-2b weights,
    its pool (prompts written by its ``prefill_chunk``) and its tails
    (folded by its ``fold_pool``; one slot folds nothing) carried across,
    the pool and tails placed on a 2 x 2 mesh as in
    ``test_sharded_sketched_steps_match_unsharded``.  Logits within the
    sketched model tolerance of tests/test_torch_kv_sketch.py (3% of
    max|logit|), and the greedy token where the reference's top two
    logits stand further apart than twice that."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import reduced_config as ref_reduced
    from repro.models import transformer as rtf
    from repro.serve import kv_sketch as rkvs
    from repro_torch.launch import shardings as SH
    from repro_torch.models import bridge
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_sketch as kvs

    cfg, tcfg = ref_reduced("gemma-2b"), _cfg("gemma-2b")
    assert cfg.serve.kv_sketch_rows == tcfg.serve.kv_sketch_rows == SK_ROWS
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = tf.tree_map(lambda t: t.float(), bridge.from_reference(
        jax.tree.map(np.asarray, params), tcfg, device="cpu"))
    rules, _ = SH.make_rules(tcfg, "decode", long_context, False)
    C = kvs.tail_cols(SK_SEQ, SK_RATIO)
    tcache = M.init_slot_cache(tcfg, SK_SLOTS, SK_SEQ, "cpu",
                               SH.cache_split(rules, {"data": 2, "model": 2}),
                               tail=(SK_ROWS, C))
    tables = tcache["tables"].numpy()
    NB1, bs = tcache["kv"]["k"].shape[1], tcache["kv"]["k"].shape[2]
    cache = rtf.init_paged_cache(cfg, NB1, bs)   # the port's sink block too
    rng = np.random.RandomState(8)
    lens = [48, 32, 64, 48]
    for b, n in enumerate(lens):
        prompt = rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int32)
        for off in range(0, n, bs):
            cache = rtf.prefill_chunk(params, cache,
                                      jnp.asarray(prompt[:, off:off + bs]),
                                      jnp.asarray(tables[b]), off, cfg)
    fb = np.array([32, 0, 48, 16], np.int32)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    jc = rkvs.tail_coeffs(cfg.serve)
    tail = rkvs.fold_pool(
        cache["kv"], {n: jnp.zeros((L, SK_SLOTS, SK_ROWS, C, K, hd),
                                   jnp.float32) for n in ("k", "v")},
        jnp.asarray(tables), jnp.zeros((SK_SLOTS,), jnp.int32),
        jnp.asarray(fb), jc, fold_cap=48)
    T = tables.shape[1] * bs
    sk = {"fold_base": jnp.asarray(fb), "onehot": rkvs.pos_onehot(jc, T, C)}
    pos = np.asarray(lens, np.int32)
    cur = rng.randint(0, cfg.vocab_size, (SK_SLOTS, 1)).astype(np.int32)
    draft = rng.randint(0, cfg.vocab_size, (SK_SLOTS, 3)).astype(np.int32)
    want_d, c1 = rtf.decode_step(params, {**cache, "tail": tail},
                                 jnp.asarray(cur), jnp.asarray(pos), cfg,
                                 tables=jnp.asarray(tables), sketch=sk)
    want_v, _ = rtf.verify_step(params, c1, jnp.asarray(draft),
                                jnp.asarray(pos + 1), cfg,
                                jnp.asarray(tables), sketch=sk)
    for k in ("k", "v"):
        tcache["kv"][k] = bridge.to_torch(np.asarray(cache["kv"][k]),
                                          "cpu").float()
    tcache["tail"] = bridge.tail_from_reference(
        jax.tree.map(np.asarray, tail), "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a))
    state = {"fold_base": t(fb), "fold_cap": 0,
             "script": [(None, t(cur).long(), "decode"),
                        (None, t(draft).long(), "verify")],
             "index": [t(pos), t(pos + 1)]}
    torch.save({"params": tparams, "cache": tcache, **state},
               tmp_path / "in.pt")
    _spawn(4, tmp_path, _sketched_rank, long_context)
    got = torch.load(tmp_path / "out.pt")
    assert torch.equal(got["fold_base"], t(fb))
    V = cfg.vocab_size
    for what, want in (("logits0", want_d), ("logits1", want_v)):
        w = np.asarray(want)[..., :V]
        g = got[what][..., :V].numpy()
        tol = SK_REF_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)
        srt = np.sort(w, axis=-1)
        sure = srt[..., -1] - srt[..., -2] > 2 * tol
        np.testing.assert_array_equal(g.argmax(-1)[sure], w.argmax(-1)[sure])


# ---------------------------------------------------------------------------
# Expert-parallel MoE train step on a 2 x 2 mesh
# ---------------------------------------------------------------------------


def _ep_step(rank, world, tmp):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.moe import EXPERT_LEAVES
    from repro_torch.models.sharding import logical_rules
    from repro_torch.models.transformer import param_leaves

    cfg = _cfg("deepseek-moe-16b")
    E = cfg.moe.num_experts
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    SH.expert_parallel = lambda c: True     # E 8 on a 2-wide model axis
    SH._FSDP_MIN_BYTES = 0
    rules, strategy = SH.make_rules(cfg, "train", False, False, 4)
    rules["ctx_shards"] = 2
    assert rules["experts"] == "model" and rules["moe_groups"] == ("data",)
    params = SH.distribute(state["params"], SH.build_param_pspecs(
        cfg, state["params"], rules, strategy), mesh)
    batch = SH.distribute(state["batch"], {
        k: (rules["batch"], None) for k in state["batch"]}, mesh)
    experts = [p for blk in params["blocks"] for k, p in blk["moe"].items()
               if k in EXPERT_LEAVES]
    shapes = set()
    for p in experts:
        loc = tuple(p.to_local().shape)
        shapes |= {loc, (E // 2,) + tuple(p.shape[1:])}
    model_ranks = tuple(dist.get_process_group_ranks(mesh.get_group("model")))
    out = {}
    for form, r in (("ep", rules), ("gathered", dict(rules, experts=None))):
        cm = CA.CostMode()
        with logical_rules(r), implicit_replication(), cm:
            loss, grads = M.make_train_step(cfg)(params, batch)
        local = [tuple(g.to_local().shape) for blk in grads["blocks"]
                 for k, g in blk["moe"].items() if k in EXPERT_LEAVES]
        out[form] = {
            "loss": loss.full_tensor(),
            "grads": [[g.full_tensor() for g in pieces]
                      for _, pieces in param_leaves(grads)],
            "expert_grads_local": local,
            "expert_model_gathers": sum(
                1 for op, ranks, ins, _, _ in cm.collectives
                if op == "all-gather" and ranks == model_ranks
                and ins and ins[0] in shapes)}
    out["experts_local"] = [tuple(p.to_local().shape) for p in experts]
    if rank == 0:
        torch.save(out, os.path.join(tmp, "out.pt"))


def test_expert_parallel_train_step_keeps_experts_sharded(tmp_path):
    """Reduced deepseek-moe (E 8, f32) on a 2 x 2 (data, model) mesh under
    forced expert parallelism (the reference's rule asks E % 16): each
    rank's expert leaves and their gradients hold E / 2 experts, no
    all-gather of an expert leaf runs over the model axis (the gathered
    form, the same placements with the rules' ``experts`` unset, has
    them), and the loss and every gradient equal the gathered form's
    within LOSS_TOL / GRAD_TOL["f32"], the unsharded step's too, and the
    loss the reference's within REF_LOSS_TOL."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import reduced_config as ref_reduced
    from repro.models import transformer as rtf
    from repro_torch.models import bridge
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import param_leaves

    cfg, tcfg = ref_reduced("deepseek-moe-16b"), _cfg("deepseek-moe-16b")
    E = tcfg.moe.num_experts
    params = rtf.init_params(jax.random.PRNGKey(2), cfg)
    tparams = tf.tree_map(lambda t: t.float(), bridge.from_reference(
        jax.tree.map(np.asarray, params), tcfg, device="cpu"))
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (4, 65))
    batch = {"tokens": toks[:, :64], "labels": toks[:, 1:]}
    ref_loss = float(rtf.loss_fn(params, {k: jnp.asarray(v, jnp.int32)
                                          for k, v in batch.items()}, cfg))
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    torch.save({"params": tparams, "batch": tbatch}, tmp_path / "in.pt")
    loss, grads = M.make_train_step(tcfg)(tparams, tbatch)
    _spawn(4, tmp_path, _ep_step)
    out = torch.load(tmp_path / "out.pt")
    L = tcfg.num_layers
    assert len(out["experts_local"]) == 3 * L
    for shp in out["experts_local"] + out["ep"]["expert_grads_local"]:
        assert shp[0] == E // 2, shp
    assert out["ep"]["expert_model_gathers"] == 0
    assert out["gathered"]["expert_model_gathers"] >= 3 * L
    ep, gat = out["ep"], out["gathered"]
    assert abs(float(ep["loss"]) - float(gat["loss"])) <= LOSS_TOL * abs(
        float(gat["loss"]))
    assert abs(float(ep["loss"]) - float(loss)) <= LOSS_TOL * abs(
        float(loss))
    assert abs(float(ep["loss"]) - ref_loss) <= REF_LOSS_TOL * abs(ref_loss)
    for (name, want), got, base in zip(param_leaves(grads), ep["grads"],
                                       gat["grads"]):
        for w, g, b in zip(want, got, base):
            for ref_g in (b, w):
                scale = float(ref_g.abs().max()) or 1.0
                err = float((g - ref_g).abs().max())
                assert err <= GRAD_TOL["f32"] * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# The pod-wise compressed step
# ---------------------------------------------------------------------------


def _podwise(rank, world, tmp):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import grad_compress as gc

    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    cfg = state["cfg"]
    mesh = make_mesh((world,), ("pod",), "cpu")
    tables = state["tables"]
    step = gc.make_podwise_compressed_step(
        cfg, mesh, hashes=lambda c, s, dev: tables[c.leaf_id])
    half = {k: v.chunk(world)[rank] for k, v in state["batch"].items()}
    ef = gc.init_error_feedback(state["params"])
    loss, grads, _ = step(state["params"], ef, half, state["step"])
    if rank == 0:
        torch.save({"loss": loss, "grads": grads,
                    "sent": step.allreduced}, os.path.join(tmp, "out.pt"))


def test_podwise_step_matches_reference_compressed_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import reduced_config as ref_reduced
    from repro.models import transformer as rtf
    from repro.train import grad_compress as rgc
    from repro_torch.models import bridge
    from repro_torch.models.transformer import param_leaves
    from repro_torch.train import grad_compress as gc

    wide = dict(d_model=128, d_ff=256)
    cfg = dataclasses.replace(ref_reduced("yi-9b"), **wide)
    tcfg = dataclasses.replace(_cfg("yi-9b"), **wide)
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (4, 17))
    batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
    step = 5
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.sketch.seed), step)
    codecs = gc._leaf_codecs(tparams, cfg.sketch.grad_hash_ratio)
    tables = {}
    for c in codecs:
        if c is not None:
            hs = rgc._codec_hashes(rgc.LeafCodec(*c), key)
            tables[c.leaf_id] = tuple(bridge.to_torch(np.asarray(t), "cpu")
                                      for t in hs)
    torch.save({"cfg": tcfg, "params": tparams, "tables": tables,
                "step": step,
                "batch": {k: torch.as_tensor(v).long()
                          for k, v in batch.items()}}, tmp_path / "in.pt")
    ef = rgc.init_error_feedback(params, cfg.sketch.grad_hash_ratio)
    rloss, rgrads, _ = rgc.make_compressed_train_step(cfg)(
        params, ef, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
        step)
    _spawn(2, tmp_path, _podwise)
    out = torch.load(tmp_path / "out.pt")
    assert out["sent"]["sketch"] == sum(4 * c.Jt for c in codecs
                                        if c is not None) > 0
    np.testing.assert_allclose(float(out["loss"]), float(rloss), rtol=2e-3)
    ref_leaves = jax.tree.leaves(rgrads)
    for (name, pieces), r, c in zip(param_leaves(out["grads"]), ref_leaves,
                                    codecs):
        r = np.asarray(r.astype(jnp.float32))
        got = (torch.stack([p.float() for p in pieces]).numpy()
               if name.startswith("blocks/") else pieces[0].float().numpy())
        np.testing.assert_allclose(got, r, rtol=0,
                                   atol=POD_TOL * np.abs(r).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------


def _restore(rank, world, tmp):
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.transformer import param_leaves
    from repro_torch.train import checkpoint as ckpt

    cfg = _cfg("yi-9b")
    saved = torch.load(os.path.join(tmp, "saved.pt"), weights_only=False)
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    rules, strategy = SH.make_rules(cfg, "train", False, False, 4)
    SH._FSDP_MIN_BYTES = 0
    like = M.param_specs(cfg)
    like = SH.tree_map_specs(lambda t, _: torch.zeros(t.shape, dtype=t.dtype),
                             like, like)
    specs = SH.build_param_pspecs(cfg, like, rules, strategy)
    _, state = ckpt.restore(os.path.join(tmp, "ckpt"), {"params": like},
                            placements={"params": specs}, mesh=mesh)
    ok, n_sharded = True, 0
    for (name, got), (_, want) in zip(param_leaves(state["params"]),
                                      param_leaves(saved)):
        for g, w in zip(got, want):
            n_sharded += any(not p.is_replicate() for p in g.placements)
            full = g.full_tensor()
            ok &= full.dtype == w.dtype and torch.equal(
                full.view(torch.int16) if full.dtype == torch.bfloat16
                else full, w.view(torch.int16)
                if w.dtype == torch.bfloat16 else w)
    torch.save({"ok": ok, "n_sharded": n_sharded},
               os.path.join(tmp, f"out{rank}.pt"))


def test_checkpoint_restores_bitwise_onto_a_two_rank_mesh(tmp_path):
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt

    params = tf.init_params(_cfg("yi-9b"), seed=3, device="cpu")
    ckpt.save(str(tmp_path / "ckpt"), 7, {"params": params})
    torch.save(params, tmp_path / "saved.pt")
    _spawn(2, tmp_path, _restore)
    for r in range(2):
        out = torch.load(tmp_path / f"out{r}.pt")
        assert out["ok"] and out["n_sharded"] > 0


# ---------------------------------------------------------------------------
# Sketched AdamW and Adagrad on DTensor parameters
# ---------------------------------------------------------------------------

TABLE_TOL = 1e-5         # of max|table|, sharded vs unsharded (f32 sums)
OPT_LR = {"adamw": 3e-4, "adagrad": 1e-2}


def _opt(kind):
    from repro_torch.sketch import optimizer as O
    if kind == "adamw":
        return O.sketched_adamw_init, lambda g, st, p: O.sketched_adamw_update(
            g, st, p, lr=OPT_LR[kind])
    return O.sketched_adagrad_init, lambda g, st, p: O.sketched_adagrad_update(
        g, st, p, lr=OPT_LR[kind])


def _tables(st):
    """The sketch tables of a state, whole, in leaf order."""
    from repro_torch.sketch.csvec import CSVec
    full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                      else t.clone())
    out = []
    for mo in st.moments:
        for sk in ((mo.m, mo.v) if hasattr(mo, "m") else (mo,)):
            if isinstance(sk, CSVec):
                out.append(full(sk.table))
    return out


def _sharded_opt(rank, world, tmp, kind, shape):
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import param_leaves, tree_map
    from repro_torch.sketch.csvec import CSVec

    cfg = _cfg("yi-9b")
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    rules, strategy = SH.make_rules(cfg, "train", False, False, 4)
    SH._FSDP_MIN_BYTES = 0
    specs = SH.build_param_pspecs(cfg, state["params"], rules, strategy)
    pd = SH.distribute(tree_map(torch.clone, state["params"]), specs, mesh)
    init, update = _opt(kind)
    st = init(pd, 4, 3, 1024)
    from repro_torch.kernels.ref import piece_layout
    from repro_torch.sketch.optimizer import shard_pieces
    sketched = lambda mo: isinstance(getattr(mo, "m", mo), CSVec)
    strided = sum(piece_layout(pc)[2] > 0 for (_, ps), mo in zip(
        param_leaves(pd), st.moments) if sketched(mo)
        for pc in shard_pieces(ps, ps, mesh)[1])
    local_shapes = []
    for i, g in enumerate(state["grads"]):
        update(SH.distribute(g, specs, mesh), st, pd)
        if i == 0:
            params = [t.full_tensor() for _, ps in param_leaves(pd)
                      for t in ps]
            tables1 = _tables(st)
        for mo in st.moments:
            for sk in ((mo.m, mo.v) if hasattr(mo, "m") else (mo,)):
                if isinstance(sk, CSVec):
                    local_shapes.append((tuple(sk.table.shape),
                                         tuple(sk.table.to_local().shape),
                                         sk.table.placements))
    out = {"params": params, "tables1": tables1, "tables": _tables(st),
           "local_shapes": local_shapes, "strided": strided,
           "sharded": sum(1 for _, ps in param_leaves(pd) for p in ps
                          if any(not x.is_replicate() for x in p.placements))}
    if rank == 0:
        torch.save(out, os.path.join(tmp, "out.pt"))


def _direction(kind, sk_tables, coeffs, n, off):
    """The step direction the plain estimates of the tables give a piece
    (AdamW's m_hat/bc1 / (sqrt(v_hat/bc2) + eps), or Adagrad's
    1 / (sqrt(v_hat) + eps) times g, left to the caller)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.sketch.csvec import CSVec, query
    from repro_torch.train.optimizer import bias_corrections
    idx = torch.arange(off, off + n)
    if kind == "adamw":
        bc1, bc2 = bias_corrections(0.9, 0.95, 1)
        mh, vh = kref.sketch_retrieve_ref(n, off, sk_tables[0], sk_tables[1],
                                          coeffs[0], coeffs[1])
        return (mh / bc1) / (torch.sqrt(vh.clamp(min=0) / bc2) + 1e-8)
    vh = query(CSVec(table=sk_tables[0], coeffs=coeffs[0], d=0,
                     signed=False), idx).clamp_min(0.0)
    return 1.0 / (torch.sqrt(vh) + 1e-8)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["adamw", "adagrad"])
def test_sketched_optimizer_on_a_sharded_mesh_matches_unsharded(
        kind, shape, tmp_path):
    """Sketched AdamW / Adagrad on FSDP-placed DTensor params (every leaf
    of reduced yi-9b split, the byte threshold lowered to 0) against the
    unsharded step: each rank sketches its strided blocks into zero tables,
    the partial tables are reduce-scattered onto the column shards and
    gathered for the step.  After two steps the gathered tables are within
    ``TABLE_TOL`` of max|table| of the unsharded ones (the partial sums add
    in another order) and between the steps the tables' local shapes are
    column shards; after the first step the dense leaves are bitwise and
    each sketched leaf's params within lr x D + one ulp of the unsharded
    step's, D the largest difference of the step direction the two
    runs' tables give through the plain estimates."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import param_leaves, tree_map
    from repro_torch.sketch.csvec import CSVec

    params = tf.init_params(_cfg("yi-9b"), seed=6, device="cpu")
    g = torch.Generator().manual_seed(7)
    grads = [tree_map(lambda t: torch.randn(t.shape, generator=g).to(
        t.dtype), params) for _ in range(2)]
    torch.save({"params": params, "grads": grads}, tmp_path / "in.pt")
    init, update = _opt(kind)
    st = init(params, 4, 3, 1024)
    ref_params = tree_map(torch.clone, params)
    update(grads[0], st, ref_params)
    want1 = _tables(st)
    step1 = [t.clone() for _, ps in param_leaves(ref_params) for t in ps]
    update(grads[1], st, ref_params)
    _spawn(shape[0] * shape[1], tmp_path, _sharded_opt, kind, shape)
    out = torch.load(tmp_path / "out.pt")
    assert out["sharded"] > 0 and out["strided"] > 0
    want = _tables(st)
    assert want and len(out["tables"]) == len(want)
    for got, ref in zip(out["tables1"] + out["tables"], want1 + want):
        assert float((got - ref).abs().max()) <= TABLE_TOL * float(
            ref.abs().max())
    world = shape[0] * shape[1]
    for full, local, pl in out["local_shapes"]:
        assert local[0] == full[0] and (
            local[1] < full[1] or all(x.is_replicate() for x in pl)), (
            full, local, pl)
        assert any(x.is_shard(1) for x in pl) or world == 1
    # params after the first step: dense leaves bitwise, sketched ones
    # within lr x D + 1 ulp
    lr = OPT_LR[kind]
    got_p, it, ti, k = iter(out["params"]), iter(want1), iter(out["tables1"]), 0
    for (_, ps), (_, gs), mo in zip(param_leaves(params),
                                    param_leaves(grads[0]), st.moments):
        sketches = ([mo.m, mo.v] if hasattr(mo, "m") else [mo])
        if not isinstance(sketches[0], CSVec):
            for p0, p in zip(ps, step1[k:k + len(ps)]):
                got = next(got_p)
                assert torch.equal(got.view(torch.int16),
                                   p.view(torch.int16))
            k += len(ps)
            continue
        ref_t = [next(it) for _ in sketches]
        got_t = [next(ti) for _ in sketches]
        coeffs = [sk.coeffs for sk in sketches]
        off = 0
        for p, gr in zip(ps, gs):
            n = p.numel()
            d = [_direction(kind, t, coeffs, n, off) for t in (ref_t, got_t)]
            if kind == "adagrad":
                d = [x * gr.float().reshape(-1) for x in d]
            D = float((d[0] - d[1]).abs().max())
            got = next(got_p).float().reshape(-1)
            want_p = step1[k].float().reshape(-1)
            _, e = torch.frexp(torch.maximum(got.abs(), want_p.abs()))
            ulp = torch.ldexp(torch.ones_like(got), e - 1) * torch.finfo(
                torch.bfloat16).eps
            assert bool(((got - want_p).abs() <= lr * D + ulp).all()), (
                kind, shape, k)
            off += n
            k += 1


def test_strided_piece_plain_version_equals_per_row_pieces():
    """A strided piece ``(g, offset, row, stride)`` (a rank's block of a
    matrix split along its columns) through the plain accumulate, retrieve
    and step is bitwise the same block given as one contiguous piece a
    row."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.sketch.hashing import cached_coeffs

    gen = torch.Generator().manual_seed(3)
    rows, cols, c0, w = 24, 40, 16, 12          # the block [:, 16:28]
    g = torch.randn((rows, w), generator=gen).to(torch.bfloat16)
    p = torch.randn((rows, w), generator=gen).to(torch.bfloat16)
    base = 1000
    strided = [(g, base + c0, w, cols)]
    per_row = [(g[r], base + r * cols + c0) for r in range(rows)]
    cm, cv = cached_coeffs(11, 3), cached_coeffs(12, 3)
    m0 = torch.randn((3, 256), generator=gen)
    v0 = torch.rand((3, 256), generator=gen)
    outs = []
    for pieces in (strided, per_row):
        m, v = m0.clone(), v0.clone()
        ops.sketch_accumulate_op(pieces, m, v, cm, cv, b1=0.9, b2=0.95)
        est = list(ops.sketch_update_op(pieces, m.clone(), v.clone(), cm, cv,
                                        b1=1.0, b2=1.0))
        q = p.clone()
        params = [q] if pieces is strided else list(q)
        ops.sketch_step_op(pieces, [t.reshape(-1) for t in params], m, v,
                           cm, cv, lr=1e-3, eps=1e-8, weight_decay=0.01,
                           bc1=0.1, bc2=0.05)
        outs.append((m, v, torch.cat([e[0] for e in est]),
                     torch.cat([e[1] for e in est]), q))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    idx = kref.piece_coords(rows * w, base + c0, w, cols, "cpu")
    assert torch.equal(idx.reshape(rows, w), base + torch.arange(
        rows)[:, None] * cols + c0 + torch.arange(w)[None, :])


def test_block_pieces_cover_any_block():
    """``block_pieces`` of a rank's block, split along any set of dims:
    the pieces' coordinates (``piece_coords``) are the block's elements'
    coordinates in the flat leaf, in the block's own order."""
    from repro_torch.kernels.ref import piece_coords, piece_layout
    from repro_torch.sketch.optimizer import block_pieces

    rng = np.random.RandomState(0)
    for _ in range(300):
        shape = list(rng.randint(1, 6, rng.randint(1, 5)))
        local, off = [], []
        for n in shape:
            a = rng.randint(0, n) if rng.rand() < 0.5 else 0
            b = rng.randint(a + 1, n + 1) if a or rng.rand() < 0.5 else n
            local.append(b - a)
            off.append(a)
        base = int(rng.randint(0, 100))
        full = base + torch.arange(int(np.prod(shape))).reshape(shape)
        block = full[tuple(slice(o, o + n) for o, n in zip(off, local))]
        got = []
        for idx, o, row, stride in block_pieces(shape, local, off, base):
            sub = block[idx].reshape(-1)
            _, o, row, stride = piece_layout((sub, o, row, stride))
            assert torch.equal(piece_coords(sub.numel(), o, row, stride,
                                            "cpu"), sub)
            got.append(sub)
        assert torch.equal(torch.cat(got), block.reshape(-1))


def _sketched_adamw(rank, world, tmp):
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import param_leaves, tree_map
    from repro_torch.sketch.optimizer import (sketched_adamw_init,
                                              sketched_adamw_update)

    cfg = _cfg("yi-9b")
    state = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    rules, strategy = SH.make_rules(cfg, "train", False, False, 4)
    SH._FSDP_MIN_BYTES = 0
    specs = SH.build_param_pspecs(cfg, state["params"], rules, strategy)
    pd = SH.distribute(tree_map(torch.clone, state["params"]), specs, mesh)
    gd = SH.distribute(state["grads"], specs, mesh)
    st = sketched_adamw_init(pd, 4, 3, 1024)
    sketched_adamw_update(gd, st, pd)
    out = {"params": [t.full_tensor() for _, ps in param_leaves(pd)
                      for t in ps],
           "tables": _tables(st)}
    if rank == 0:
        torch.save(out, os.path.join(tmp, f"out{world}.pt"))


def test_sketched_adamw_steps_the_dtensors_of_a_mesh_of_one(tmp_path):
    """Sketched AdamW on FSDP-placed DTensor params and grads: on a (1, 1)
    mesh it steps their local tensors, tables and params bitwise the
    unsharded step's (the plain version on the CPU); on a two-rank mesh
    it steps each rank's shards, tables within ``TABLE_TOL`` of max|table|
    of the unsharded step's (the partial tables sum in another order) and
    the params as many as the unsharded step's, each finite."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import param_leaves, tree_map
    from repro_torch.sketch.optimizer import (SketchedMoments,
                                              sketched_adamw_init,
                                              sketched_adamw_update)

    params = tf.init_params(_cfg("yi-9b"), seed=6, device="cpu")
    g = torch.Generator().manual_seed(7)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                     params)
    torch.save({"params": params, "grads": grads}, tmp_path / "in.pt")
    st = sketched_adamw_init(params, 4, 3, 1024)
    sketched_adamw_update(grads, st, params)
    _spawn(1, tmp_path, _sketched_adamw)
    out = torch.load(tmp_path / "out1.pt")
    want = [t for mo in st.moments if isinstance(mo, SketchedMoments)
            for t in (mo.m.table, mo.v.table)]
    assert want and len(out["tables"]) == len(want)
    for a, b in zip(out["tables"], want):
        assert torch.equal(a, b)
    flat = [t for _, ps in param_leaves(params) for t in ps]
    assert len(out["params"]) == len(flat)
    for a, b in zip(out["params"], flat):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    _spawn(2, tmp_path, _sketched_adamw)
    out = torch.load(tmp_path / "out2.pt")
    assert len(out["tables"]) == len(want)
    for a, b in zip(out["tables"], want):
        assert float((a - b).abs().max()) <= TABLE_TOL * float(
            b.abs().max())
    assert len(out["params"]) == len(flat)
    assert all(bool(torch.isfinite(a.float()).all()) for a in out["params"])
