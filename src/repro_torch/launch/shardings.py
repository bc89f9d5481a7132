"""Spec functions for the parameter, optimizer-state, cache and serve-state
trees, and the per-arch rules (``repro/launch/shardings.py``).

Two parameter placements, as in the reference:

  fsdp : every leaf of >= 1 MiB shards its largest evenly divisible dim
         over ("data", "model") (256-way; pod-replicated on the
         multi-pod mesh, where the cross-pod gradient all-reduce is the
         FCS compression's target), else over "data".  DeepSeek's 64
         experts overlay expert parallelism: E over "model", the next
         divisible dim over "data".
  tp   : a name-based tensor-parallel map (weight-stationary decode for
         every arch; xLSTM multi-pod train and prefill).

A spec is a tuple per tensor dim (models/sharding.py), one-axis tuples
written as their names.  Spec trees mirror the trees they place; a
``None`` leaf (a tied head) stays ``None``.

**Per-layer leaves.**  The reference stacks every block leaf on a
leading L axis; the port keeps one tensor a layer (models/bridge.py).
A layer's spec here is the stacked leaf's spec with the L entry
dropped, so the FSDP byte threshold is tested against L times the
layer's bytes (the stacked leaf's): granite-moe's f32 (1536, 40) router
is 240 KiB a layer, 7.5 MiB stacked over 32, so its 1536 dim shards
over ("data", "model") as in the reference.

**The paged pool's write sink.**  The port's pool (L, NB + 1, bs, K,
hd) keeps one write-sink block per layer after the NB blocks the tables
index (models/layers.py).  A sharded pool is *padded*: ``pool_blocks``
sizes NB so that NB + 1 is a multiple of the block axis's split, the
blocks past the tables' are never referenced, and the sink stays the
last block.  The block axis then divides evenly; a parity check against
the reference's pool compares the spec of ``[:, :NB]``.

**The decode cache.**  The reference's dry-run cache is dense, (L, B,
S, K, hd) split over ("batch", "kv_seq").  The port's is the paged pool
(``models/model.py:cache_specs``), whose block axis ``cache_pspecs``
splits over the batch axes and then the ``kv_blocks`` axes, the tables
laid out to match (slot groups major, a slot's blocks strided over the
kv shards): each device holds as many rows as the reference's split of
the dense cache, plus the padding.  The engine's state
(``serve_state_pspecs``) keeps the reference's paged placement: the
block axis over ``kv_blocks`` alone.

**The port's own state leaves** take a spec by the reference's rule for
slot state: they ride the batch axis or replicate.
  - the tails: one stacked (2, L, B, Z, C, K, hd) tensor, the
    reference's {"k", "v"} of (L, B, Z, C, K, hd): the same spec with
    the leading 2 replicated;
  - ``DecodeState`` has no ``keys``: the per-slot sampling generators
    are host objects (serve/scheduler.py) and are not placed;
  - the paged cache's ``tables`` (B, nb) of ``models/model.py:
    cache_specs`` replicate, as the engine state's tables do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (MeshAxes, Spec, decode_rules,
                                         norm_spec, train_rules)

MODEL_AXIS = 16
DATA_AXIS = 16
_FSDP_MIN_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# Strategy selection
# ---------------------------------------------------------------------------


def select_strategy(cfg: ModelConfig, kind: str, multi_pod: bool,
                    global_batch: int = 0) -> str:
    if kind == "decode":
        return "tp"
    if cfg.family == "ssm":
        # xLSTM: the mLSTM KV is full-width, so context sharding would
        # all-gather dm-wide tensors: never fsdp_seq.  When the global
        # batch covers the mesh, pure batch sharding with FSDP params;
        # else inner-dim TP.
        if kind == "train" and not multi_pod and global_batch \
                and global_batch % (DATA_AXIS * MODEL_AXIS) == 0:
            return "fsdp_batch"
        return "tp"
    return "fsdp_seq"


def expert_parallel(cfg: ModelConfig) -> bool:
    """The reference's rule: a moe config's experts are split over
    ``model`` (expert parallelism) when E is a multiple of the model
    axis.  Tests on a narrower mesh replace this function."""
    return bool(cfg.moe) and cfg.moe.num_experts % MODEL_AXIS == 0


def make_rules(cfg: ModelConfig, kind: str, long_context: bool,
               multi_pod: bool, global_batch: int = 0
               ) -> Tuple[Dict[str, MeshAxes], str]:
    ep = expert_parallel(cfg)
    if kind == "decode":
        return decode_rules(multi_pod, long_context), "tp"
    strategy = select_strategy(cfg, kind, multi_pod, global_batch)
    rules = train_rules(multi_pod, strategy=strategy, expert_parallel=ep)
    if strategy == "tp" and cfg.num_heads < MODEL_AXIS:
        rules["heads"] = None
    return rules, strategy


# ---------------------------------------------------------------------------
# Walking the port's parameter tree
# ---------------------------------------------------------------------------


def map_params(fn: Callable[[str, Any, int], Any], params: Any) -> Any:
    """``fn(name, leaf, L)`` over a params-shaped tree: ``name`` is the
    leaf's key, ``L`` the length of the per-layer list it sits in (the
    reference's stacked axis), 0 outside the blocks.  Returns a tree of
    the same structure; ``None`` stays ``None``."""
    def walk(node: Any, name: str, L: int) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k, L) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, len(node)) for v in node]
        return fn(name, node, L)
    return walk(params, "", 0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# FSDP parameter specs
# ---------------------------------------------------------------------------


def _fsdp_leaf_spec(name: str, leaf: torch.Tensor, L: int,
                    cfg: ModelConfig) -> Spec:
    """The reference's ``_fsdp_leaf_spec`` of the stacked leaf (L layers
    like ``leaf``; L = 0 for a top-level leaf) with the L entry
    dropped."""
    shape = tuple(leaf.shape)
    nbytes = _nbytes(leaf) * max(L, 1)
    ep = expert_parallel(cfg)
    spec: list = [None] * len(shape)
    if name.startswith("r") and len(shape) == 3 and shape[0] <= 64:
        # sLSTM recurrent gate matrices (H, hd, hd), read inside the time
        # loop: sharding them puts a collective in every timestep
        return tuple(spec)
    if ep and name in ("we_gate", "we_up", "we_down"):
        spec[0] = "model"
        for i in range(1, len(shape)):
            if shape[i] % DATA_AXIS == 0:
                spec[i] = "data"
                break
    elif nbytes >= _FSDP_MIN_BYTES:
        cands = [(shape[i], i) for i in range(len(shape))
                 if shape[i] % (DATA_AXIS * MODEL_AXIS) == 0]
        if cands:
            _, i = max(cands)
            spec[i] = ("data", "model")
        else:
            cands = [(shape[i], i) for i in range(len(shape))
                     if shape[i] % DATA_AXIS == 0]
            if cands:
                _, i = max(cands)
                spec[i] = "data"
    return norm_spec(spec)


# ---------------------------------------------------------------------------
# TP parameter specs (name-based)
# ---------------------------------------------------------------------------


def _tp_leaf_spec(name: str, leaf: torch.Tensor, cfg: ModelConfig) -> Spec:
    inner = leaf.ndim
    m = v = "model"
    ep = expert_parallel(cfg)
    base: Optional[tuple] = None
    if name == "embed":
        base = (v, None)
    elif name == "head":
        base = (None, v)
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "ws_gate", "ws_up",
                  "wz", "wx", "wxb", "wzb", "w_up_g", "wdt"):
        base = (None, m)
    elif name in ("wi", "wf") and inner == 2 and leaf.shape[-1] > 64:
        base = (None, m)            # sLSTM gates (d, d); mLSTM (d, H) tiny
    elif name in ("wo", "w_down", "ws_down", "out_proj"):
        base = (m, None)
    elif name in ("bq", "bk", "bv", "conv_bx", "conv_b"):
        base = (m,)
    elif name in ("we_gate", "we_up"):
        base = (m, None, None) if ep else (None, None, m)
    elif name == "we_down":
        base = (m, None, None) if ep else (None, m, None)
    elif name in ("conv_wx", "conv_w"):
        base = (None, m)
    elif name in ("dt_bias", "A_log", "D") and inner == 1:
        base = (m,)                 # mamba per-head params (H % 16 == 0)
    elif name == "norm" and inner == 1 and leaf.shape[-1] % MODEL_AXIS == 0 \
            and leaf.shape[-1] > cfg.d_model:
        base = (m,)                 # inner-dim gated norms (mamba / mlstm)
    elif name.startswith("r") and inner == 3:
        base = (None, None, m)      # sLSTM recurrent (H, hd, hd)
    if base is None:
        base = (None,) * inner
    return norm_spec(tuple(base) + (None,) * (inner - len(base)))


def build_param_pspecs(cfg: ModelConfig, params_tree: Any, rules,
                       strategy: str) -> Any:
    """A spec tree like ``params_tree`` (the port's layout; meta tensors
    from ``models/model.py:param_specs`` will do)."""
    if strategy in ("fsdp_seq", "fsdp_batch"):
        return map_params(lambda n, t, L: _fsdp_leaf_spec(n, t, L, cfg),
                          params_tree)
    return map_params(lambda n, t, L: _tp_leaf_spec(n, t, cfg), params_tree)


# ---------------------------------------------------------------------------
# Optimizer-state specs
# ---------------------------------------------------------------------------


def table_spec(table: torch.Tensor) -> Spec:
    """Sketch tables are (rows, cols), cols lane-aligned: shard cols as
    FSDP shards the largest param dim, rows replicated (rows ~ 3)."""
    c = table.shape[1]
    if c % (DATA_AXIS * MODEL_AXIS) == 0:
        return (None, ("data", "model"))
    if c % DATA_AXIS == 0:
        return (None, "data")
    return (None, None)


def opt_state_pspecs(cfg: ModelConfig, opt_state: Any,
                     param_specs: Any) -> Any:
    """Specs of an optimizer state: dense (m, v) moments take their
    parameter's spec (ZeRO-3), sketch tables shard their columns, the
    (rows, 4) hash coefficients and the step replicate."""
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sketch.csvec import CSVec
    from repro_torch.sketch.optimizer import (DenseMoments,
                                              SketchedAdamWState,
                                              SketchedMoments)

    if not isinstance(opt_state, SketchedAdamWState):
        return type(opt_state)(step=(), m=param_specs, v=param_specs)

    def csvec(c: CSVec) -> CSVec:
        return CSVec(table=table_spec(c.table), coeffs=(None, None),
                     d=c.d, signed=c.signed, seed=c.seed)

    out = []
    for mo, (_, pspecs) in zip(opt_state.moments,
                               param_leaves(param_specs)):
        if isinstance(mo, SketchedMoments):
            out.append(SketchedMoments(m=csvec(mo.m), v=csvec(mo.v)))
        else:
            out.append(DenseMoments(m=list(pspecs), v=list(pspecs)))
    return SketchedAdamWState(step=(), moments=out)


# ---------------------------------------------------------------------------
# Cache specs (decode)
# ---------------------------------------------------------------------------


def _pool_spec(kb: MeshAxes) -> Spec:
    return norm_spec((None, kb, None, None, None))


def cache_split(rules: Dict[str, MeshAxes], sizes: Dict[str, int]
                ) -> Tuple[int, int]:
    """(n_b, n_kv): how many ways ``cache_pspecs`` splits a paged pool's
    block axis over the batch axes and over the ``kv_blocks`` axes on a
    mesh of axis ``sizes``."""
    from repro_torch.models.sharding import axes_size
    return (axes_size(rules.get("batch"), sizes),
            axes_size(rules.get("kv_blocks"), sizes))


def _cache_pool_spec(rules: Dict[str, MeshAxes]) -> Spec:
    from repro_torch.models.sharding import entry_axes
    axes = entry_axes(rules.get("batch")) + entry_axes(rules.get("kv_blocks"))
    return _pool_spec(axes)


def _tail_spec(b: MeshAxes, kb: MeshAxes) -> Spec:
    """The port's stacked (2, L, B, Z, C, K, hd) tails: the reference's
    (L, B, Z, C, K, hd) spec with the k / v axis replicated."""
    return norm_spec((None, None, b, None, kb, None, None))


def cache_pspecs(cfg: ModelConfig, cache_tree: Any,
                 rules: Dict[str, MeshAxes]) -> Any:
    """Specs of a cache: a recurrent family's stacked slot state (the
    reference's leaf names and layouts), or an attention family's paged
    cache {"kv": pool, "tables"[, "tail"]} (``models/model.py:
    cache_specs`` with ``cache_split(rules, ...)``): its block axis over
    the batch axes, then the ``kv_blocks`` axes (module docstring), the
    tables replicated."""
    b = rules.get("batch")
    ks = rules.get("kv_seq")
    kb = rules.get("kv_blocks")
    m = "model" if rules.get("ssm_inner") else None

    def leaf_spec(path: Tuple[str, ...], leaf: torch.Tensor) -> Spec:
        name = path[-1]
        parent = path[-2] if len(path) > 1 else ""
        nd = leaf.ndim
        if parent == "kv" and name in ("k", "v"):   # (L, NB + 1, bs, K, hd)
            return _cache_pool_spec(rules)
        if name == "tables":                 # (B, nb), paged
            return (None, None)
        if name == "tail":
            return _tail_spec(b, kb)
        if name in ("k", "v"):               # (L|G, B, S, K, hd)
            return norm_spec((None, b, ks, None, None))
        if name == "ssm":                    # (L, B, H, N, P)
            return norm_spec((None, b, m, None, None))
        if name in ("conv_x", "conv_BC"):    # (L, B, cw-1, C)
            return norm_spec((None, b, None,
                              m if name == "conv_x" else None))
        if name == "C":                      # (n, B, H, hd, hd)
            return norm_spec((None, b, None, m, None))
        if name == "n":                      # (n, B, H, hd)
            return norm_spec((None, b, None, m))
        if name == "conv":                   # (n, B, 3, dm)
            return norm_spec((None, b, None, m))
        if name == "m":                      # (n, B, H)
            return norm_spec((None, b, None))
        if name in ("c", "h"):               # sLSTM states (n, B, H, hd)
            return norm_spec((None, b, None, m))
        return (None,) * nd

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path, node)

    return walk(cache_tree, ())


# ---------------------------------------------------------------------------
# Continuous-batching engine state specs (decode)
# ---------------------------------------------------------------------------


def serve_state_pspecs(cfg: ModelConfig, state: Any,
                       rules: Dict[str, MeshAxes]) -> Any:
    """Specs of a ``serve/scheduler.py:DecodeState``.

    Attention families carry the paged pool, whose block axis takes the
    split-KV role (rules["kv_blocks"]) and whose tables replicate (every
    shard needs the whole logical -> physical map); the FCS tails shard
    their bucket columns the same way.  A spec engine's draft pool
    shares the target pool's block geometry and placement.  Recurrent
    families keep the stacked slot state ``cache_pspecs`` places.
    Per-slot bookkeeping and sampling state ride the batch axis."""
    from repro_torch.serve.scheduler import DecodeState

    assert isinstance(state, DecodeState)
    b = rules.get("batch")
    slot = lambda a: norm_spec((b,) + (None,) * (a.ndim - 1))
    paged = state.tables.shape[-1] > 0
    if paged:
        kb = rules.get("kv_blocks")

        def sub(c: dict) -> dict:
            out = {"kv": {k: _pool_spec(kb) for k in c["kv"]}}
            if "tail" in c:
                out["tail"] = _tail_spec(b, kb)
            return out

        cache = sub(state.cache)
        if "draft" in state.cache:
            cache["draft"] = sub(state.cache["draft"])
        tables: Spec = (None, None)
    else:
        cache = cache_pspecs(cfg, state.cache, rules)
        tables = slot(state.tables)
    return DecodeState(
        cache=cache, tables=tables, cur=slot(state.cur),
        pos=slot(state.pos), remaining=slot(state.remaining),
        temp=slot(state.temp), top_k=slot(state.top_k),
        fold_base=slot(state.fold_base), spec_k=slot(state.spec_k))


def draft_param_pspecs(draft, rules: Dict[str, MeshAxes]) -> Any:
    """Specs of a speculative draft's params (models/draft.py:Draft):
    weight-stationary TP on the decode mesh, like the served params; the
    FCS-sketched head (J, padded_vocab) shards its vocab dim."""
    return build_param_pspecs(draft.cfg, draft.params, rules, "tp")


# ---------------------------------------------------------------------------
# Placing trees on a mesh
# ---------------------------------------------------------------------------


def pool_blocks(num_blocks: int, multiple: int) -> int:
    """The pool's block count NB' >= ``num_blocks`` with NB' + 1 (the
    write sink included) a multiple of ``multiple``."""
    return -(-(num_blocks + 1) // multiple) * multiple - 1


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements (``distribute_tensor``: each rank keeps its shard of the
    tensor it holds; ``tree`` must be equal on every rank)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.sharding import placements

    def one(t, s):
        return distribute_tensor(t, mesh, placements(s, mesh))

    return tree_map_specs(one, tree, specs)


def tree_map_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the tensors of ``tree`` (dicts, lists and
    dataclasses) and the matching spec tuples; other leaves (ints,
    ``None``) pass through."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [tree_map_specs(fn, v, s) for v, s in zip(tree, specs)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_specs(fn, getattr(tree, f.name),
                                   getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    return tree
