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
