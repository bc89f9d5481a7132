"""FCS gradient compression (port of ``repro/train/grad_compress.py``):
the paper's fast count sketch applied to every large gradient leaf of a
training step.

Each leaf of at least ``MIN_COMPRESS_ELEMS`` elements is read as a 2-D
tensor (I1, k) with k = ``grad_hash_ratio`` (its flat vector zero-padded
to a whole number of rows) and sketched by FCS with per-mode hash
lengths J_n = I_n: bucket h1(i1) + h2(i2), sign s1(i1) s2(i2), sketch
length J~ = I1 + k - 1, a factor-k reduction of the bytes an all-reduce
of the gradient would move.  The estimate ``unsketch(sketch(g))``
replaces the gradient before the optimizer sees it.  Smaller leaves pass
through.  On one process the round trip is the whole effect (the
reference's note: sketch and unsketch are linear, so unsketching the
mean of the sketches equals unsketching the sketch of the mean).

**Leaves are the reference's.**  Leaf ids, sizes and codecs follow
``models/transformer.py:param_leaves``: a stacked (L, ...) block leaf of
the reference is the port's L per-layer pieces, and element j of layer
l is flat index l * numel_layer + j of the leaf.  The sketch is built
piece by piece and, within a piece, in chunks of ``CHUNK`` elements: an
element's row i1 = idx // k and column i2 = idx % k give its bucket and
sign, and no (I1, k) table of a whole stacked leaf is ever made (at
yi-9b a ``w_gate`` leaf has 2.16e9 elements).  The padded tail adds
nothing to the sketch and is dropped from the estimate.

**Hashes** (h1 (I1,) int32, s1 (I1,) f32 +-1, h2 (k,) int32, s2 (k,)
f32 +-1) are drawn fresh for every (leaf, step) from a
``torch.Generator`` on the gradient's device seeded from
(``cfg.sketch.seed``, step, leaf id), so a resumed run regenerates them
with no state; the draws differ from ``jax.random``'s.  The leaf
functions take the tables as an argument, so a test can feed both
packages the reference's own ``_codec_hashes`` output.

Design note, kept from the reference: error feedback is deliberately
NOT accumulated.  EF theory requires a contractive (biased,
norm-reducing) compressor; sketch-unsketch is unbiased with
lambda_max(S^T S) ~ 2k, so EF either stalls on the fixed null space
(fixed hashes) or amplifies (fresh hashes).  The unbiased estimator plus
the per-step rehash is the principled pairing: E_t[S_t^T S_t] = I under
fresh hashes, plain SGD convergence theory with (1 + omega)-variance
gradients applies, and Adam's per-coordinate normalization absorbs the
variance in practice.  ``init_error_feedback`` keeps the reference's
zero (1,) leaves for the checkpoint's and the API's shape.

The sketch is a scatter-add and the estimate a gather, in plain
PyTorch, as the reference's are plain jnp (``.at[pos].add``; no Pallas
kernel lies on this path).  The sketch adds in an order fixed by the
shapes and the hashes (``sketch_leaf``: each chunk's whole rows summed
by their row bucket h1 after a stable sort, then added column by column
at the shifts h2; no two terms of a bucket in one atomic add), so two
runs, and a resumed run, agree bitwise on the card too.

``make_podwise_compressed_step`` is the reference's pod-wise step (a
``shard_map`` over the multi-pod mesh's "pod" axis): each pod rank
computes its batch shard's gradients, sketches every compressed leaf with
the step's shared hashes and all-reduces only the sketches (J~ f32
each) over the pod group, with the uncompressed leaves and the loss;
each then unsketches the mean sketch.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import Params, param_leaves
from repro_torch.sketch.csvec import index_add_ordered_

MIN_COMPRESS_ELEMS = 1 << 16
CHUNK = 1 << 26            # elements of a piece hashed (and sketched) at once

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# called as probe(codec, pieces, tables, sketch) for every compressed
# leaf, after its sketch is made and before the estimate overwrites the
# gradient pieces; None outside checks
probe: Optional[Callable] = None


class LeafCodec(NamedTuple):
    leaf_id: int
    I1: int
    k: int
    Jt: int
    pad: int


def _leaf_codecs(params: Params, ratio: int) -> List[Optional[LeafCodec]]:
    """One codec per reference leaf (``param_leaves`` order), None for a
    leaf that passes through."""
    codecs: List[Optional[LeafCodec]] = []
    for i, (_, pieces) in enumerate(param_leaves(params)):
        n = sum(p.numel() for p in pieces)
        if n < MIN_COMPRESS_ELEMS:
            codecs.append(None)
            continue
        I1 = -(-n // ratio)
        codecs.append(LeafCodec(i, I1, ratio, I1 + ratio - 1,
                                I1 * ratio - n))
    return codecs


def hash_seed(seed: int, step: int, leaf_id: int) -> int:
    return ((int(seed) * 1_000_003 + int(step)) * 1_000_003
            + int(leaf_id)) % (1 << 63)


def codec_hashes(c: LeafCodec, seed: int, step: int,
                 device: torch.device) -> Tables:
    """Fresh (h1, s1, h2, s2) of leaf ``c`` at ``step``, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(hash_seed(seed, step, c.leaf_id))
    kw = dict(generator=g, device=device)
    h1 = torch.randint(0, c.I1, (c.I1,), dtype=torch.int32, **kw)
    s1 = 1.0 - 2.0 * torch.randint(0, 2, (c.I1,), dtype=torch.float32, **kw)
    h2 = torch.randint(0, c.k, (c.k,), dtype=torch.int32, **kw)
    s2 = 1.0 - 2.0 * torch.randint(0, 2, (c.k,), dtype=torch.float32, **kw)
    return h1, s1, h2, s2


def _chunks(pieces: Sequence[torch.Tensor], c: LeafCodec, tables: Tables
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(flat view of a piece's chunk, its buckets int64, its signs f32),
    piece by piece in leaf order."""
    h1, s1, h2, s2 = tables
    off = 0
    for p in pieces:
        flat = p.view(-1)
        for a in range(0, flat.numel(), CHUNK):
            b = min(a + CHUNK, flat.numel())
            idx = torch.arange(off + a, off + b, device=p.device)
            i1 = torch.div(idx, c.k, rounding_mode="floor")
            i2 = idx - i1 * c.k
            pos = h1[i1].long() + h2[i2].long()
            yield flat[a:b], pos, s1[i1] * s2[i2]
        off += flat.numel()


def _add_elements(sk: torch.Tensor, flat: torch.Tensor, start: int,
                  a: int, b: int, c: LeafCodec, tables: Tables) -> None:
    """Elements [a, b) of a piece's flat view (the piece's first element
    is leaf index ``start``) added one term at a time
    (``index_add_ordered_``)."""
    if b <= a:
        return
    h1, s1, h2, s2 = tables
    idx = torch.arange(start + a, start + b, device=flat.device)
    i1 = torch.div(idx, c.k, rounding_mode="floor")
    i2 = idx - i1 * c.k
    index_add_ordered_(sk, h1[i1].long() + h2[i2].long(),
                       flat[a:b].float() * (s1[i1] * s2[i2]))


def _add_rows(sk: torch.Tensor, rows: torch.Tensor, r0: int, c: LeafCodec,
              tables: Tables) -> None:
    """Whole rows r0, r0 + 1, ... of the leaf's (I1, k) view (``rows``:
    their elements, flat): each row times s1 summed into its bucket
    h1(i1), the rows of one bucket in row order (a stable sort of the
    buckets, then a sum of each bucket's run), then column i2 of those
    sums times s2(i2) added at h1 + h2(i2), column by column.  Within one
    column's add the buckets are distinct, so each receives one term."""
    h1, s1, h2, s2 = tables
    m = rows.numel() // c.k
    i1 = torch.arange(r0, r0 + m, device=rows.device)
    key, order = torch.sort(h1[i1].long(), stable=True)
    buckets, counts = torch.unique_consecutive(key, return_counts=True)
    vals = rows.float().view(m, c.k) * s1[i1][:, None]
    sums = torch.segment_reduce(vals[order], "sum", lengths=counts, axis=0)
    for j in range(c.k):
        sk.index_add_(0, buckets + h2[j].long(), sums[:, j] * s2[j])


def sketch_leaf(pieces: Sequence[torch.Tensor], c: LeafCodec,
                tables: Tables) -> torch.Tensor:
    """FCS sketch of one gradient leaf given as its pieces: (J~,) f32.

    Chunk by chunk (``CHUNK`` elements of a piece, in leaf order), in an
    order fixed by the shapes and the hashes: the elements of a row that
    the chunk's edges cut, one at a time; the chunk's whole rows through
    ``_add_rows``; then the cut row at its end.  No two terms of a bucket
    meet in one add with atomics, so the card sums each bucket as the
    CPU does, run after run."""
    sk = torch.zeros((c.Jt,), dtype=torch.float32, device=pieces[0].device)
    start = 0
    for p in pieces:
        flat = p.view(-1)
        n = flat.numel()
        for a in range(0, n, CHUNK):
            b = min(a + CHUNK, n)
            lo = min(b, a + (-(start + a)) % c.k)     # first whole row
            hi = max(lo, b - (start + b) % c.k)       # end of the last
            _add_elements(sk, flat, start, a, lo, c, tables)
            if hi > lo:
                _add_rows(sk, flat[lo:hi], (start + lo) // c.k, c, tables)
            _add_elements(sk, flat, start, hi, b, c, tables)
        start += n
    return sk


def unsketch_leaf(sk: torch.Tensor, c: LeafCodec, tables: Tables,
                  like: Sequence[torch.Tensor],
                  dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The estimate of every element of the leaf whose pieces are shaped
    like ``like``, as new pieces in ``dtype``."""
    out = [torch.empty(p.shape, dtype=dtype, device=p.device) for p in like]
    for o, pos, sign in _chunks(out, c, tables):
        o.copy_(sk[pos] * sign)
    return out


def compress_roundtrip(pieces: Sequence[torch.Tensor], c: LeafCodec,
                       tables: Tables) -> torch.Tensor:
    """Replace a gradient leaf's pieces in place by the unbiased estimate
    unsketch(sketch(g)), in their dtype.  Returns the sketch."""
    sk = sketch_leaf(pieces, c, tables)
    if probe is not None:
        probe(c, pieces, tables, sk)
    for g, pos, sign in _chunks(pieces, c, tables):
        g.copy_(sk[pos] * sign)
    return sk


def compress_grads(grads: Params, codecs: Sequence[Optional[LeafCodec]],
                   tables: Callable[[LeafCodec], Tables]) -> None:
    """Compress every codec'd leaf of ``grads`` in place with the hashes
    ``tables(codec)``."""
    for (_, pieces), c in zip(param_leaves(grads), codecs):
        if c is not None:
            compress_roundtrip(pieces, c, tables(c))


def init_error_feedback(params: Params) -> List[torch.Tensor]:
    """The placeholder error-feedback state: one zero (1,) f32 leaf per
    reference leaf (see the design note: nothing accumulates)."""
    return [torch.zeros((1,), dtype=torch.float32, device=pieces[0].device)
            for _, pieces in param_leaves(params)]


def make_compressed_train_step(
        cfg: ModelConfig,
        hashes: Optional[Callable[[LeafCodec, int, torch.device],
                                  Tables]] = None):
    """Gradient step with FCS compression of every large leaf:
    ``train_step(params, ef, batch, step=0) -> (loss, grads, ef)``.
    ``hashes(codec, step, device)`` gives a leaf's tables (default:
    ``codec_hashes`` from ``cfg.sketch.seed``)."""
    ratio, seed = cfg.sketch.grad_hash_ratio, cfg.sketch.seed
    base = M.make_train_step(cfg)
    draw = hashes or (lambda c, step, dev: codec_hashes(c, seed, step, dev))

    def train_step(params: Params, ef, batch: Dict[str, torch.Tensor],
                   step: int = 0):
        loss, grads = base(params, batch)
        dev = loss.device
        compress_grads(grads, _leaf_codecs(params, ratio),
                       lambda c: draw(c, step, dev))
        return loss, grads, ef

    return train_step


def _pod_mean_(t: torch.Tensor, group) -> None:
    """All-reduce ``t`` to its mean over ``group`` in place (a sum, then a
    division: gloo has no averaging reduction)."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    t.div_(dist.get_world_size(group))


def make_podwise_compressed_step(
        cfg: ModelConfig, mesh,
        hashes: Optional[Callable[[LeafCodec, int, torch.device],
                                  Tables]] = None):
    """The pod-wise compressed step over ``mesh``'s "pod" axis:
    ``train_step(params, ef, batch, step=0) -> (loss, grads, ef)`` on
    every pod rank, each with its own batch shard and a copy of the
    params.  Only the sketches (and the uncompressed leaves and the
    loss) cross the pod group; ``train_step.allreduced`` then holds the
    step's all-reduced bytes, ``{"sketch": sum of J~ x 4, "dense": the
    uncompressed leaves' and the loss's}``.  ``hashes`` as for
    ``make_compressed_train_step``; every rank draws the same tables."""
    from repro_torch.launch.shardings import make_rules
    from repro_torch.models.sharding import logical_rules

    ratio, seed = cfg.sketch.grad_hash_ratio, cfg.sketch.seed
    base = M.make_train_step(cfg)
    draw = hashes or (lambda c, step, dev: codec_hashes(c, seed, step, dev))
    group = mesh.get_group("pod")

    def train_step(params: Params, ef, batch: Dict[str, torch.Tensor],
                   step: int = 0):
        # single-pod rules inside, as the reference's per-pod body
        with logical_rules(make_rules(cfg, "train", False, False)[0]):
            loss, grads = base(params, batch)
        dev = loss.device
        sent = {"sketch": 0, "dense": 0}
        for (_, pieces), c in zip(param_leaves(grads),
                                  _leaf_codecs(params, ratio)):
            if c is None:
                for g in pieces:
                    _pod_mean_(g, group)
                    sent["dense"] += g.numel() * g.element_size()
                continue
            tables = draw(c, step, dev)
            sk = sketch_leaf(pieces, c, tables)
            _pod_mean_(sk, group)                 # J~ floats cross pods
            sent["sketch"] += sk.numel() * sk.element_size()
            if probe is not None:
                probe(c, pieces, tables, sk)
            for g, pos, sign in _chunks(pieces, c, tables):
                g.copy_(sk[pos] * sign)
        loss = loss.clone()
        _pod_mean_(loss, group)
        sent["dense"] += loss.numel() * loss.element_size()
        train_step.allreduced = sent
        return loss, grads, ef

    train_step.allreduced = {"sketch": 0, "dense": 0}
    return train_step
