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
  unsharded step, and refuses params split over two ranks.

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
# Sketched AdamW on DTensor parameters
# ---------------------------------------------------------------------------


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
    try:
        sketched_adamw_update(gd, st, pd)
    except NotImplementedError as e:
        out = {"raised": str(e)}
    else:
        out = {"params": [t.full_tensor() for _, ps in param_leaves(pd)
                          for t in ps],
               "tables": [(mo.m.table, mo.v.table) for mo in st.moments
                          if hasattr(mo.m, "table")]}
    if rank == 0:
        torch.save(out, os.path.join(tmp, f"out{world}.pt"))


def test_sketched_adamw_steps_the_dtensors_of_a_mesh_of_one(tmp_path):
    """Sketched AdamW on FSDP-placed DTensor params and grads: on a (1, 1)
    mesh it steps their local tensors, tables and params bitwise the
    unsharded step's (the plain version on the CPU); on a two-rank mesh
    it raises rather than sketch one rank's shard alone."""
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
    want = [(mo.m.table, mo.v.table) for mo in st.moments
            if isinstance(mo, SketchedMoments)]
    assert want and len(out["tables"]) == len(want)
    for (am, av), (bm, bv) in zip(out["tables"], want):
        assert torch.equal(am, bm) and torch.equal(av, bv)
    flat = [t for _, ps in param_leaves(params) for t in ps]
    assert len(out["params"]) == len(flat)
    for a, b in zip(out["params"], flat):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    _spawn(2, tmp_path, _sketched_adamw)
    assert "several devices" in torch.load(tmp_path / "out2.pt")["raised"]
