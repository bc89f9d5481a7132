"""The port's dry run and cost walk against the JAX package's
(``repro/launch/dryrun.py``, ``hlo_analysis.py``):

* ``_collective_traffic`` and ``roofline_terms`` equal the reference's
  (the roofline at the reference's TPU v5e rates);
* the walk's matmul flops for a reduced yi-9b and a reduced granite-moe
  train step lie within ``FLOP_TOL`` of the reference's ``analyze`` of
  the compiled step on the CPU;
* every arch x shape x mesh cell places its parameters with exactly the
  per-device bytes the reference's specs and shapes give, and is
  ``skipped`` exactly where ``shape_applicable`` says;
* the CLI writes a cell's record, and ``cost_debug`` attributes a cell.

The cells run over PyTorch's fake process group in this process; the
module's fixture tears it down.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPE_BY_NAME as REF_SHAPES
from repro.configs.base import shape_applicable as ref_applicable
from repro.configs.registry import reduced_config as ref_reduced
from repro.launch import hlo_analysis as RH
from repro.launch import shardings as RS
from repro.models import model as RM
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import cost_debug, dryrun
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh

torch.set_num_threads(1)

# The walk counts the port's matmuls; the reference's analyze counts the
# compiled dots.  Dense models compute the same products (the port's
# attention one block of keys, the reference's flash chunks; both
# recompute every block in the backward); the reference's MoE adds its
# one-hot dispatch and combine einsums, the port gathers instead.
FLOP_TOL = {"yi-9b": 0.08, "granite-moe-3b-a800m": 0.35}

V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, dcn_bw=6.25e9)


@pytest.fixture(scope="module", autouse=True)
def _fake_group_torn_down():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collective_traffic_equals_reference():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for nbytes in (0, 77, 1024, 3 << 20):
            for g in (1, 2, 4, 16, 256):
                assert CA._collective_traffic(op, nbytes, g) == \
                    RH._collective_traffic(op, nbytes, g)


def test_roofline_terms_equal_reference():
    cases = [(197e12, 0.0, {"ici_bytes": 0.0, "dcn_bytes": 0.0}),
             (0.0, 819e9, {"ici_bytes": 50e9, "dcn_bytes": 0.0}),
             (3e12, 5e10, {"ici_bytes": 1e9, "dcn_bytes": 2e8}),
             (0.0, 0.0, {})]
    for flops, hbm, coll in cases:
        assert CA.roofline_terms(flops, hbm, coll, **V5E) == \
            RH.roofline_terms(flops, hbm, coll)
    # the port's own rates: the H100 SXM's
    t = CA.roofline_terms(989e12, 3.35e12, {"ici_bytes": 0.0})
    assert t["t_compute_s"] == 1.0 and t["t_memory_s"] == 1.0


@pytest.mark.parametrize("arch", sorted(FLOP_TOL))
def test_walk_flops_match_reference_analyze(arch):
    from repro.models import transformer as rtf
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    B, S = 2, 64
    params = jax.eval_shape(lambda: rtf.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    hlo = jax.jit(RM.make_train_step(cfg)).lower(params, batch).compile()
    want = RH.analyze(hlo.as_text())["flops"]
    tparams = M.param_specs(tcfg)
    tbatch = {k: torch.zeros((B, S), dtype=torch.int64, device="meta")
              for k in ("tokens", "labels")}
    with CA.CostMode() as walk:
        M.make_train_step(tcfg)(tparams, tbatch)
    assert walk.flops > 0 and walk.hbm_bytes > 0 and walk.peak > 0
    assert abs(walk.flops - want) <= FLOP_TOL[arch] * want, (walk.flops,
                                                             want)


def _ref_param_bytes(cfg, shape, multi_pod) -> int:
    sizes = {"data": 16, "model": 16, "pod": 2}
    rules, strat = RS.make_rules(cfg, shape.kind, shape.name == "long_500k",
                                 multi_pod, shape.global_batch)
    ps = RM.param_specs(cfg)
    specs = RS.build_param_pspecs(cfg, ps, rules, strat)
    sl = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(ps), sl):
        spec = Sh.norm_spec(tuple(spec))
        n = 1
        for i, d in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            k = Sh.axes_size(e, sizes)
            assert d % k == 0
            n *= d // k
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_bytes_per_device_exact(arch, multi_pod):
    cfg = get_config(arch)
    for shape in SHAPES:
        applicable = ref_applicable(cfg, REF_SHAPES[shape.name])
        assert dryrun.shape_applicable(cfg, shape) == applicable
        if not applicable:      # the record says so before any walk
            cell = dryrun.run_cell(arch, shape.name, multi_pod)
            assert cell["status"] == "skipped", cell
            continue
        placed = dryrun.place_cell(cfg, shape, multi_pod)
        assert placed["n_dev"] == (512 if multi_pod else 256)
        assert placed["param_bytes"] == _ref_param_bytes(
            cfg, REF_SHAPES[shape.name], multi_pod), shape.name


def test_cli_writes_a_cell_record(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                 "--out", str(out)])
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["mesh"] == "16x16"
    mem = cell["memory"]
    assert mem["peak_bytes_per_device"] > mem["argument_bytes_per_device"]
    assert mem["param_bytes_per_device"] < mem["argument_bytes_per_device"]
    assert cell["cost"]["flops_per_device"] > 0
    assert cell["collectives"]["ici_bytes"] > 0
    # split-KV: the ranks merge their softmax statistics
    assert cell["collective_ops"]["all-reduce_count"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert math.isclose(cell["params_total"], 2506172416)


def test_cost_debug_attributes_a_cell(capsys):
    cell = cost_debug.compile_cell("gemma-2b", "train_4k", layers=1,
                                   batch=16, seq=256)
    rows = cost_debug.attribute(cell, top=5, what="flops")
    assert rows and all(v > 0 for _, _, v in rows)
    assert any("layers.py" in name for t, name, _ in rows if t == "by_site")
    out = capsys.readouterr().out
    assert "op by flops" in out and "site by flops" in out
