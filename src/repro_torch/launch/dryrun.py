"""Multi-pod dry run (``repro/launch/dryrun.py``): every (arch x shape x
mesh) cell run once on the production mesh as a planning walk, with its
memory, cost and collective record.

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices.  The port builds the mesh in one process over PyTorch's
fake process group (a rank 0 whose collectives return at once), places
the parameters, the batch and the cache as DTensors of meta tensors
with the cell's specs (launch/shardings.py), and runs the step once
under ``cost_analysis.CostMode``: rank 0's local shards, op by op.  It
allocates nothing and touches no card; it is a planning tool, never a
fallback of the card's path.

Per device: argument bytes are exact (the local shards' shapes), the
peak is the arguments plus the most the walk held live, flops, bytes
and collectives are the walk's (cost_analysis.py).  ``params_total``,
``params_active``, ``model_flops`` and ``useful_flops_ratio`` use the
reference's formulas.  A cell that DTensor cannot carry is recorded
with ``status: "error"`` and the error, which names the op.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import SHAPES, SHAPE_BY_NAME, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks as the default group (rank
    0), replacing an earlier fake one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               "real process group is initialised here")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def local_bytes(tree) -> int:
    """Bytes this rank holds of every tensor of ``tree``."""
    from repro_torch.launch.shardings import tree_map_specs
    total = [0]

    def one(t, _):
        loc = t.to_local() if hasattr(t, "to_local") else t
        total[0] += loc.numel() * loc.element_size()
        return t

    tree_map_specs(one, tree, tree)
    return total[0]


def _shard_inputs(tree, axes_of, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.sharding import placements
    return {k: distribute_tensor(v, mesh, placements(axes_of(v), mesh))
            for k, v in tree.items()}


def place_cell(cfg, shape, multi_pod: bool,
               mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """The cell's mesh and placed arguments: the parameters and the
    batch, or the decode step's cache, tokens and index, as DTensors of
    meta tensors with the cell's specs over a fake group of the mesh's
    size.  Returns {"mesh", "n_dev", "rules", "strategy", "pmeta",
    "params", "cache" (None without one), "inputs", "argument_bytes",
    "param_bytes"}, the bytes this rank's shards hold."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh, production_shape
    from repro_torch.models import model as M

    mshape, axes = production_shape(multi_pod)
    if mesh_shape is not None:
        mshape = tuple(mesh_shape)
    n_dev = math.prod(mshape)
    fake_group(n_dev)
    mesh = make_mesh(mshape, axes, "meta")
    rules, strategy = SH.make_rules(cfg, shape.kind,
                                    shape.name == "long_500k", multi_pod,
                                    shape.global_batch)
    pmeta = M.param_specs(cfg)
    specs = M.input_specs(cfg, shape, SH.cache_split(
        rules, dict(zip(axes, mshape))))
    params = SH.distribute(
        pmeta, SH.build_param_pspecs(cfg, pmeta, rules, strategy), mesh)
    cache = None
    if "cache" in specs:
        cache = SH.distribute(specs["cache"], SH.cache_pspecs(
            cfg, specs["cache"], rules), mesh)
    rows = lambda v: (rules["batch"],) + (None,) * (v.ndim - 1)
    inputs = _shard_inputs(specs["batch"] if "batch" in specs else
                           {k: specs[k] for k in ("tokens", "index")},
                           rows, mesh)
    args = [params] + ([cache] if cache is not None else []) + [inputs]
    return {"mesh": mesh, "n_dev": n_dev, "rules": rules,
            "strategy": strategy, "pmeta": pmeta, "params": params,
            "cache": cache, "inputs": inputs,
            "argument_bytes": sum(local_bytes(a) for a in args),
            "param_bytes": local_bytes(params)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sketch_grads: bool = False, sketched_head: bool = False,
             extra_tag: str = "", zero1: bool = False, *,
             layers: Optional[int] = None, batch: Optional[int] = None,
             seq: Optional[int] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             sites: bool = False) -> dict:
    """One cell's record.  ``layers`` / ``batch`` / ``seq`` cut the config
    and the shape, ``mesh_shape`` replaces the production mesh's (same
    axes) — the card's check at a mesh of one; ``sites`` keeps the
    walk's per-op and per-function tables (cost_debug.py) and its list of
    collectives (op, group ranks, shapes, site).  ``zero1`` is
    accepted and ignored, as in the reference."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import SketchConfig
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch.mesh import production_shape
    from repro_torch.models import model as M
    from repro_torch.models.sharding import logical_rules

    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    mshape = (tuple(mesh_shape) if mesh_shape is not None
              else production_shape(multi_pod)[0])
    cell = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mshape),
        "kind": shape.kind, "tag": extra_tag,
    }
    if not shape_applicable(cfg, shape):
        cell["status"] = "skipped"
        cell["reason"] = ("long_500k needs sub-quadratic attention; "
                          f"{arch} is pure full-attention (see DESIGN.md)")
        return cell
    if sketch_grads or sketched_head:
        cfg = dataclasses.replace(cfg, sketch=SketchConfig(
            sketched_head=sketched_head, grad_compression=sketch_grads))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq or shape.seq_len)
    if layers or batch or seq:
        cell["cut"] = {"layers": cfg.num_layers,
                       "global_batch": shape.global_batch,
                       "seq_len": shape.seq_len}

    t0 = time.time()
    try:
        placed = place_cell(cfg, shape, multi_pod, mshape)
        cell["strategy"] = placed["strategy"]
        params, cache, inputs = (placed["params"], placed["cache"],
                                 placed["inputs"])
        n_dev, pmeta = placed["n_dev"], placed["pmeta"]
        arg_bytes = placed["argument_bytes"]
        t_place = time.time() - t0
        t0 = time.time()
        cm = CA.CostMode(pod_size=math.prod(mshape[-2:]), sites=sites)
        with logical_rules(placed["rules"]), implicit_replication(), \
                CommDebugMode() as comm, cm:
            if shape.kind == "train":
                step = M.make_train_step(cfg)
                loss, grads = step(params, inputs)
                if sketch_grads:
                    _compress_replicated(cfg, grads)
                out_bytes = local_bytes({"loss": loss, "grads": grads})
                alias = 0
            elif shape.kind == "prefill":
                step = M.make_prefill_step(cfg)
                logits, new_cache = step(params, inputs, cache)
                out_bytes = local_bytes({"logits": logits, "cache":
                                         new_cache})
                alias = local_bytes(cache) if cache is not None else 0
            else:
                step = M.make_serve_step(cfg)
                logits, _ = step(params, cache, inputs["tokens"],
                                 inputs["index"])
                out_bytes = local_bytes({"logits": logits, "cache": cache})
                alias = local_bytes(cache)
        t_walk = time.time() - t0
    except Exception as e:   # the op DTensor could not carry, or a bug
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"[:4000]
        cell["traceback"] = traceback.format_exc()[-4000:]
        return cell

    cost = cm.totals()
    coll = {"ici_bytes": cost["ici_bytes"], "dcn_bytes": cost["dcn_bytes"],
            "per_op": cost["per_op"]}
    flops_dev = cost["flops"]
    terms = CA.roofline_terms(flops_dev, cost["hbm_bytes"], coll)

    # model FLOPs: 6*N*D train / 2*N*D forward over ACTIVE params
    n_params = sum(t.numel() for t in _leaves(pmeta))
    n_active = n_params
    if cfg.moe:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.expert_d_ff
        n_active -= (m.num_experts - m.top_k) * per_expert * cfg.num_layers
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * n_active * tokens
    useful_ratio = model_flops / (flops_dev * n_dev) if flops_dev else 0.0

    cell.update({
        "status": "ok",
        "t_place_s": round(t_place, 2),
        "t_walk_s": round(t_walk, 2),
        "devices": n_dev,
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "param_bytes_per_device": placed["param_bytes"],
            "output_bytes_per_device": out_bytes,
            "alias_bytes_per_device": alias,
            "activation_peak_bytes_per_device": cm.peak,
            "peak_bytes_per_device": arg_bytes + cm.peak,
        },
        "cost": {"flops_per_device": flops_dev,
                 "hbm_bytes_per_device": cost["hbm_bytes"]},
        "collectives": {k: v for k, v in coll.items() if k != "per_op"},
        "collective_ops": coll["per_op"],
        "comm_debug_counts": {str(k): v for k, v in
                              comm.get_comm_counts().items()},
        "roofline": terms,
        "params_total": int(n_params),
        "params_active": int(n_active),
        "model_flops": model_flops,
        "useful_flops_ratio": useful_ratio,
    })
    if sites:
        cell["by_op"] = {k: dict(v) for k, v in cm.by_op.items()}
        cell["by_site"] = {k: dict(v) for k, v in cm.by_site.items()}
        cell["collective_list"] = [list(c) for c in cm.collectives]
    return cell


def _leaves(tree):
    from repro_torch.models.transformer import param_leaves
    return [t for _, pieces in param_leaves(tree) for t in pieces]


def _compress_replicated(cfg, grads) -> None:
    """FCS compression of the step's gradients (the reference's global
    form: sketch and unsketch are linear, so compressing the reduced
    gradient equals unsketching the mean sketch): each compressed leaf
    is reduced and replicated, then sketched and estimated locally with
    meta hash tables."""
    from repro_torch.models.sharding import replicate
    from repro_torch.train import grad_compress as GC

    ratio = cfg.sketch.grad_hash_ratio

    def tables(c):
        meta = lambda n, dt: torch.zeros((n,), dtype=dt, device="meta")
        return (meta(c.I1, torch.int32), meta(c.I1, torch.float32),
                meta(c.k, torch.int32), meta(c.k, torch.float32))

    from repro_torch.models.transformer import param_leaves
    codecs = GC._leaf_codecs(grads, ratio)
    for (_, pieces), c in zip(param_leaves(grads), codecs):
        if c is not None:
            GC.compress_roundtrip([replicate(p).to_local() for p in pieces],
                                  c, tables(c))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--sketch-grads", action="store_true",
                    help="FCS gradient compression of the reduced grads")
    ap.add_argument("--sketched-head", action="store_true",
                    help="FCS-sketched LM head")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = ([s.name for s in SHAPES] if args.all or not args.shape
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))
            for r in results if r.get("status") in ("ok", "skipped")}
    todo = []
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name, args.tag) in done:
                    continue
                todo.append(dict(arch=arch, shape_name=shape,
                                 multi_pod=multi_pod,
                                 sketch_grads=args.sketch_grads,
                                 sketched_head=args.sketched_head,
                                 extra_tag=args.tag, zero1=args.zero1))

    def record(cell):
        nonlocal results
        key = (cell["arch"], cell["shape"], cell["mesh"], cell.get("tag", ""))
        print(f"=== {key[0]} x {key[1]} x {key[2]}"
              f"{' [' + args.tag + ']' if args.tag else ''} ===", flush=True)
        print(json.dumps({k: cell.get(k) for k in
                          ("status", "t_walk_s", "error")})[:600],
              flush=True)
        if cell["status"] == "ok":
            mem = cell["memory"]["peak_bytes_per_device"] / 2**30
            rf = cell["roofline"]
            print(f"  peak {mem:.2f} GiB/dev | compute "
                  f"{rf['t_compute_s']*1e3:.2f} ms | memory "
                  f"{rf['t_memory_s']*1e3:.2f} ms | coll "
                  f"{rf['t_collective_s']*1e3:.2f} ms | "
                  f"dominant={rf['dominant']}", flush=True)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"],
                       r.get("tag", "")) != key]
        results.append(cell)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, args.out)

    t0 = time.time()
    for kw in todo:
        record(run_cell(**kw))
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"DONE: {n_ok} ok, {n_skip} skipped, {n_err} errors -> "
          f"{args.out} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
