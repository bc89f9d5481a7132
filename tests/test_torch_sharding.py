"""Parity of the port's launch rules and spec functions with the JAX
package's (``repro/models/sharding.py``, ``repro/launch/shardings.py``):
rules, strategies and every parameter, optimizer-state, cache,
serve-state and draft spec equal the reference's after one-axis
normalisation (jax 0.9 compares ``P(("data",))`` as ``P("data")``), a
port layer's spec being the reference's stacked leaf's with the L entry
dropped; every spec divides its dim at the production mesh sizes; and the
model's spec trees (``param_specs``, ``input_specs``) match the
reference's shapes and dtypes through the bridge's leaf correspondence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import reduced_config as ref_reduced
from repro.launch import shardings as RS
from repro.models import model as RM
from repro.models import sharding as RSh
from repro.models import transformer as rtf
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import shardings as SH
from repro_torch.models import bridge
from repro_torch.models import draft as dr
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh
from repro_torch.models.transformer import param_leaves
from repro_torch.serve.scheduler import SlotScheduler

SIZES = {"data": 16, "model": 16, "pod": 2}
KINDS = ("train", "prefill", "decode")


def ref_spec(p) -> tuple:
    """A reference ``PartitionSpec`` as the port's normalised tuple."""
    return Sh.norm_spec(tuple(p))


def ref_rules(r: dict) -> dict:
    """The reference's rules dict as it is: the port keeps the same dict
    (one-axis tuples included; ``spec_for`` normalises the specs)."""
    return dict(r)


def divides(shape, spec) -> bool:
    return all(n % Sh.axes_size(e, SIZES) == 0 for n, e in zip(shape, spec))


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in kp)


def ref_leaf_specs(tree, specs) -> dict:
    """{reference leaf path: (stacked shape, normalised spec)}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sl = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return {_path(kp): (tuple(l.shape), ref_spec(s))
            for (kp, l), s in zip(leaves, sl)}


# ---------------------------------------------------------------------------
# Rules and strategies
# ---------------------------------------------------------------------------


def test_norm_and_placements():
    assert Sh.norm_spec((None, ("data",), ("data", "model"), ())) == (
        None, "data", ("data", "model"), None)
    assert ref_spec(jax.sharding.PartitionSpec(None, ("data",))) == (
        None, "data")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_sets_equal_reference(multi_pod):
    for strategy in ("fsdp_seq", "fsdp_batch", "tp"):
        for ep in (False, True):
            assert Sh.train_rules(multi_pod, strategy, ep) == ref_rules(
                RSh.train_rules(multi_pod, strategy, ep))
    for lc in (False, True):
        assert Sh.decode_rules(multi_pod, lc) == ref_rules(
            RSh.decode_rules(multi_pod, lc))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_and_strategy_equal_reference(arch):
    cfg = get_config(arch)
    batches = sorted({s.global_batch for s in SHAPES} | {0})
    for kind in KINDS:
        for lc in (False, True):
            for mp in (False, True):
                for gb in batches:
                    assert SH.select_strategy(cfg, kind, mp, gb) == \
                        RS.select_strategy(cfg, kind, mp, gb)
                    rules, strat = SH.make_rules(cfg, kind, lc, mp, gb)
                    rrules, rstrat = RS.make_rules(cfg, kind, lc, mp, gb)
                    assert strat == rstrat
                    assert rules == ref_rules(rrules), (kind, lc, mp, gb)


# ---------------------------------------------------------------------------
# Parameter specs at the production sizes
# ---------------------------------------------------------------------------


def _param_trees(arch):
    cfg = get_config(arch)
    return cfg, M.param_specs(cfg), RM.param_specs(cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Every arch x {train, prefill, decode} x {16x16, 2x16x16}: each port
    layer leaf's spec is the reference's stacked leaf's with L dropped,
    each top-level leaf's equal, and every spec divides its dim; shapes
    and dtypes match through the bridge's correspondence."""
    cfg, port, ref = _param_trees(arch)
    gb = {s.kind: s.global_batch for s in SHAPES}
    for kind in KINDS:
        for mp in (False, True):
            rules, strat = SH.make_rules(cfg, kind, False, mp, gb[kind])
            rrules, rstrat = RS.make_rules(cfg, kind, False, mp, gb[kind])
            ports = SH.build_param_pspecs(cfg, port, rules, strat)
            refs = ref_leaf_specs(ref, RS.build_param_pspecs(
                cfg, ref, rrules, rstrat))
            seen = set()
            for (path, pieces), (_, specs) in zip(param_leaves(port),
                                                  param_leaves(ports)):
                shape, want = refs[path]
                seen.add(path)
                stacked = path.startswith("blocks")
                assert len(set(specs)) == 1, path
                got = specs[0]
                assert got == (want[1:] if stacked else want), (
                    kind, mp, path, got, want)
                for t in pieces:
                    assert divides(t.shape, got), (path, t.shape, got)
            assert seen == set(refs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_input_shapes_equal_reference(arch):
    cfg, port, ref = _param_trees(arch)
    refs = {_path(kp): l for kp, l in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    for path, pieces in param_leaves(port):
        want = refs[path]
        shape = ((len(pieces),) + tuple(pieces[0].shape)
                 if path.startswith("blocks") else tuple(pieces[0].shape))
        assert shape == tuple(want.shape), path
        assert str(pieces[0].dtype).split(".")[-1] == str(want.dtype)
        assert all(t.device.type == "meta" for t in pieces)
    # input specs: the port's token ids are int64 (PyTorch indexes with
    # int64; the reference's are int32); the decode index is per slot
    # (B,); an attention family's decode cache is the paged pool
    for shape in SHAPES:
        p_in = M.input_specs(cfg, shape)
        r_in = RM.input_specs(cfg, shape)
        if shape.kind == "train":
            for k, v in r_in["batch"].items():
                t = p_in["batch"][k]
                assert tuple(t.shape) == tuple(v.shape), k
                want = (torch.int64 if v.dtype == jnp.int32
                        else torch.bfloat16)
                assert t.dtype == want
        elif shape.kind == "decode":
            assert tuple(p_in["tokens"].shape) == tuple(
                r_in["tokens"].shape)
            assert tuple(p_in["index"].shape) == (shape.global_batch,)
            if cfg.family in ("ssm", "hybrid"):
                for kp, v in jax.tree_util.tree_flatten_with_path(
                        r_in["cache"])[0]:
                    node = p_in["cache"]
                    for k in kp:
                        node = node[k.key]
                    assert tuple(node.shape) == tuple(v.shape), _path(kp)
            else:
                k = p_in["cache"]["kv"]["k"]
                nb = -(-shape.seq_len // cfg.serve.kv_block_size)
                assert k.shape[1] == shape.global_batch * nb + 1
                assert tuple(p_in["cache"]["tables"].shape) == (
                    shape.global_batch, nb)


# ---------------------------------------------------------------------------
# Optimizer-state specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b"])
def test_opt_state_pspecs_equal_reference(arch):
    """Sketched AdamW state of a reduced config (leaves of >= 4096
    elements sketched): tables, coefficients and dense moments placed as
    the reference's."""
    from repro.sketch.optimizer import sketched_adamw_init as rinit
    from repro_torch.sketch.optimizer import (SketchedMoments,
                                              sketched_adamw_init)
    tcfg, rcfg = reduced_config(arch), ref_reduced(arch)
    tp = M.param_specs(tcfg)
    rp = RM.param_specs(rcfg)
    rules, strat = SH.make_rules(tcfg, "train", False, False, 256)
    rrules, rstrat = RS.make_rules(rcfg, "train", False, False, 256)
    tstate = sketched_adamw_init(tp, 4, 3, 4096)
    rstate = rinit(rtf.init_params(jax.random.PRNGKey(0), rcfg), 4, 3, 4096)
    tspec = SH.opt_state_pspecs(tcfg, tstate, SH.build_param_pspecs(
        tcfg, tp, rules, strat))
    rspec = RS.opt_state_pspecs(rcfg, rstate, RS.build_param_pspecs(
        rcfg, rp, rrules, rstrat))
    rmo = jax.tree.leaves(rspec.moments, is_leaf=lambda x: hasattr(x, "m"))
    assert len(rmo) == len(tspec.moments)
    n_sketched = 0
    for got, want, (path, _) in zip(tspec.moments, rmo, param_leaves(tp)):
        if isinstance(got, SketchedMoments):
            n_sketched += 1
            for a, b in ((got.m, want.m), (got.v, want.v)):
                assert a.table == ref_spec(b.table), path
                assert a.coeffs == ref_spec(b.coeffs)
        else:
            stacked = path.startswith("blocks")
            for piece in got.m + got.v:
                assert piece == ref_spec(want.m)[1 if stacked else 0:], path
    assert n_sketched > 0
    assert tspec.step == () and ref_spec(rspec.step) == ()


# ---------------------------------------------------------------------------
# Cache specs (every family)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_reference(arch):
    """Recurrent families: every slot-state leaf's spec equals the
    reference's ``cache_pspecs``.  Attention families: the paged pool
    (the port's decode cache) splits its block axis over the batch axes,
    then the ``kv_blocks`` axes, so that a device holds the rows of the
    reference's (batch, kv_seq) split of its dense cache plus one block
    of padding (the pool is padded so NB + 1 divides the split); its
    tables replicate; every spec divides its dim."""
    cfg = get_config(arch)
    for shape in SHAPES:
        if shape.kind != "decode" or not (
                shape.name != "long_500k" or cfg.supports_long_context):
            continue
        lc = shape.name == "long_500k"
        rules, _ = SH.make_rules(cfg, "decode", lc, False)
        rrules, _ = RS.make_rules(cfg, "decode", lc, False)
        cache = M.cache_specs(cfg, shape.global_batch, shape.seq_len,
                              SH.cache_split(rules, SIZES))
        specs = SH.cache_pspecs(cfg, cache, rules)
        rcache = RM.input_specs(cfg, next(
            s for s in REF_SHAPES if s.name == shape.name))["cache"]
        rspecs = RS.cache_pspecs(cfg, rcache, rrules)
        if cfg.family in ("ssm", "hybrid"):
            for kp, rs_ in jax.tree_util.tree_flatten_with_path(
                    rspecs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]:
                node, leaf = specs, cache
                for k in kp:
                    node, leaf = node[k.key], leaf[k.key]
                assert node == ref_spec(rs_), (shape.name, _path(kp))
                assert divides(leaf.shape, node), _path(kp)
            continue
        pool = Sh.norm_spec((None, Sh.entry_axes(rules["batch"])
                             + Sh.entry_axes(rules["kv_blocks"]), None,
                             None, None))
        bs = cfg.serve.kv_block_size
        for k in ("k", "v"):
            assert specs["kv"][k] == pool
            t = cache["kv"][k]
            assert divides(t.shape, pool)
            rspec = ref_spec(rspecs["kv"][k])
            ref_rows = (rcache["kv"][k].shape[1] * rcache["kv"][k].shape[2]
                        // Sh.axes_size(rspec[1], SIZES)
                        // Sh.axes_size(rspec[2], SIZES))
            rows = t.shape[1] // Sh.axes_size(pool[1], SIZES) * bs
            assert ref_rows < rows <= ref_rows + bs, (shape.name, rows,
                                                     ref_rows)
        assert specs["tables"] == (None, None)


# ---------------------------------------------------------------------------
# Serve-state and draft specs on reduced schedulers
# ---------------------------------------------------------------------------

# the port's own state leaves and the reference's that the port has not
PORT_ONLY = {"tail": "one stacked (2, L, B, Z, C, K, hd) tensor"}
REF_ONLY = {"keys": "per-slot generators are host objects"}


def _schedulers(arch, **serve_kw):
    rcfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    base = dict(max_batch=2, max_seq=64, prefill_bucket=16,
                kv_block_size=16, prefix_block=16)
    base.update(serve_kw)
    rserve = dataclasses.replace(rcfg.serve, **base)
    tserve = dataclasses.replace(tcfg.serve, **base)
    return (rcfg, RefScheduler(rcfg, params, serve=rserve), tcfg,
            SlotScheduler(tcfg, tparams, serve=tserve, device="cpu"))


@pytest.mark.parametrize("arch,kw", [
    ("gemma-2b", {}),
    ("gemma-2b", {"kv_sketch_window": 32, "kv_sketch_ratio": 4,
                  "spec_k": 2, "draft_depth": 1}),
    ("xlstm-1.3b", {}),
    ("zamba2-2.7b", {}),
])
def test_serve_state_pspecs_equal_reference(arch, kw):
    rcfg, rs, tcfg, ts = _schedulers(arch, **kw)
    for lc in (False, True):
        rules = Sh.decode_rules(False, lc)
        rrules = RSh.decode_rules(False, lc)
        got = SH.serve_state_pspecs(tcfg, ts._state, rules)
        want = RS.serve_state_pspecs(rcfg, rs.state, rrules)
        for f in dataclasses.fields(got):
            if f.name == "cache":
                continue
            assert getattr(got, f.name) == ref_spec(getattr(want, f.name)), \
                f.name
        assert set(want._fields) - {f.name for f in
                                    dataclasses.fields(got)} == set(REF_ONLY)
        if tcfg.family in ("ssm", "hybrid"):
            for kp, w in jax.tree_util.tree_flatten_with_path(
                    want.cache, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]:
                node = got.cache
                for k in kp:
                    node = node[k.key]
                assert node == ref_spec(w), _path(kp)
            continue

        def check(g, w, where):
            for k in ("k", "v"):
                assert g["kv"][k] == ref_spec(w["kv"][k]), where
            if "tail" in w:
                # the port's stacked tails: the reference's k / v spec
                # with the stacking axis replicated
                assert g["tail"] == (None,) + ref_spec(w["tail"]["k"])
                assert ref_spec(w["tail"]["k"]) == ref_spec(w["tail"]["v"])
            assert ("tail" in g) == ("tail" in w)

        check(got.cache, want.cache, "target")
        assert ("draft" in got.cache) == ("draft" in want.cache)
        if "draft" in want.cache:
            check(got.cache["draft"], want.cache["draft"], "draft")
        assert set(PORT_ONLY) == {"tail"}


@pytest.mark.parametrize("ratio", [0, 2])
def test_draft_param_pspecs_equal_reference(ratio):
    """A truncated and a count-sketch-compressed draft of reduced gemma:
    the port's per-layer specs are the reference's stacked ones with L
    dropped."""
    from repro.models import draft as rdr
    rcfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    if ratio:
        rd = rdr.Draft(*rdr.compress_params(params, rcfg, 1, ratio, 3, 7))
        td = dr.Draft(*dr.compress_params(tparams, tcfg, 1, ratio, 3, 7))
    else:
        rd = rdr.Draft(*rdr.truncate_params(params, rcfg, 1))
        td = dr.Draft(*dr.truncate_params(tparams, tcfg, 1))
    rules, rrules = Sh.decode_rules(False, False), RSh.decode_rules(
        False, False)
    got = SH.draft_param_pspecs(td, rules)
    want = ref_leaf_specs(rd.params, RS.draft_param_pspecs(rd, rrules))
    for (path, specs) in param_leaves(got):
        w = want[path][1]
        for s in specs:
            assert s == (w[1:] if path.startswith("blocks") else w), path
    assert {p for p, _ in param_leaves(got)} == set(want)
