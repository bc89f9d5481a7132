"""The plain reference of a training cell: the model's loss and gradients
(``reference/model.py``, float32) and the sketched AdamW step, followed
from the seed's weights and batches through a cell's checked steps.

Sketched AdamW, as the configuration states it: every parameter leaf of
at least ``opt_state_min_elems`` elements keeps its two moments in count
sketch tables of ``opt_state_rows`` rows (``hashing.cols_for`` columns),
the first signed (estimate: median of the rows), the second count-min of
the squared gradient (estimate: min of the rows); the leaves are the
model's parameters with every layer's tensor of one name stacked, in the
order of their paths, leaf i hashed with seeds 2i (m) and 2i + 1 (v) of
the run's hash seed.  Each step the tables decay (b1, b2) and take the
step's terms; then each element steps by
``lr (m_hat / bc1 / (sqrt(max(v_hat, 0) / bc2) + eps) + wd p)``.  Smaller
leaves keep dense moments.

The step runs layer by layer, so that a 9 B model fits beside its tables:
a forward without autograd keeps each layer's input, the loss's backward
gives the last hidden state's gradient, and each layer is run again with
autograd to pass the gradient down and to add its parameters' gradients
into the tables at once.  Parameters, tables and activations are
float32.

What it returns is what the program's run is judged by: each step's
loss, each leaf's gradient norm of the first step as worked out from the
second-moment state after that step (a count-min row sums every squared
gradient once, so ``sqrt(row sum / (1 - b2))``), each sketched leaf's
two tables after the first step projected on the run's seeded
directions (``perfbench/project.py``), and each leaf's change
``||p - p0||`` after the checked steps.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import project, traffic, weights
from perfbench.reference import hashing
from perfbench.reference import model as rm

CHUNK = 1 << 24                  # elements hashed at a time


class SketchedLeaf:
    def __init__(self, numel: int, i: int, opt: Dict[str, Any], seed: int,
                 device):
        R = opt["opt_state_rows"]
        self.C = hashing.cols_for(numel, opt["opt_state_ratio"], R)
        self.cm = hashing.coeffs(hashing.leaf_seed(seed, 2 * i), R)
        self.cv = hashing.coeffs(hashing.leaf_seed(seed, 2 * i + 1), R)
        for co in (self.cm, self.cv):
            hashing.check_fast_form(co, self.C, numel, device)
        self.m = torch.zeros((R, self.C), dtype=torch.float32, device=device)
        self.v = torch.zeros((R, self.C), dtype=torch.float32, device=device)
        # elements stepped with v_hat == 0 < |m_hat| and the squared change
        # they made, the whole squared change, and the elements that moved
        # more than 10 lr and their squared change (the look of PERF.md)
        self.zero_v = [0, 0.0, 0.0, 0, 0.0]

    def _chunks(self, flat: torch.Tensor, offset: int):
        for s in range(0, flat.numel(), CHUNK):
            part = flat[s:s + CHUNK]
            idx = offset + s + torch.arange(part.numel(), device=flat.device)
            yield s, part, hashing.u32_bits(idx)

    def add(self, g: torch.Tensor, offset: int, b1: float, b2: float) -> None:
        """Add a piece's terms (1-b1) s g and (1-b2) g^2 at coordinates
        offset.. into the (already decayed) tables."""
        for _, part, x32 in self._chunks(g.reshape(-1).float(), offset):
            bm, sm = hashing.row_hashes(self.cm, x32, self.C, True)
            bv, _ = hashing.row_hashes(self.cv, x32, self.C, False)
            for r in range(self.m.shape[0]):
                self.m[r].index_add_(0, bm[r], (1.0 - b1) * sm[r] * part)
                self.v[r].index_add_(0, bv[r], (1.0 - b2) * part * part)

    def step(self, p: torch.Tensor, offset: int, kw: Dict[str, float]) -> None:
        """Step a piece p (float32, in place) from the tables."""
        flat = p.view(-1)
        for s, part, x32 in self._chunks(flat, offset):
            bm, sm = hashing.row_hashes(self.cm, x32, self.C, True)
            bv, _ = hashing.row_hashes(self.cv, x32, self.C, False)
            m_rows = torch.stack([self.m[r][bm[r]] * sm[r]
                                  for r in range(len(bm))])
            R = m_rows.shape[0]
            srt = torch.sort(m_rows, dim=0).values
            m_hat = srt[R // 2] if R % 2 else 0.5 * (srt[R // 2 - 1]
                                                     + srt[R // 2])
            v_hat = torch.stack([self.v[r][bv[r]] for r in range(R)]).amin(0)
            new = adamw(part, m_hat, v_hat, kw)
            d2 = (new - part).square()
            zero = (v_hat == 0) & (m_hat != 0)
            big = d2 > (10.0 * kw["lr"]) ** 2
            self.zero_v[0] += int(zero.sum())
            self.zero_v[1] += float(d2[zero].sum())
            self.zero_v[2] += float(d2.sum())
            self.zero_v[3] += int(big.sum())
            self.zero_v[4] += float(d2[big].sum())
            flat[s:s + part.numel()] = new

    def grad_norm(self, b2: float) -> float:
        return float(torch.sqrt(self.v.sum(dim=1).mean() / (1.0 - b2)))


def adamw(p, m_hat, v_hat, kw):
    delta = (m_hat / kw["bc1"]) / (torch.sqrt(
        torch.clamp(v_hat, min=0.0) / kw["bc2"]) + kw["eps"]) \
        + kw["weight_decay"] * p
    return p - kw["lr"] * delta


class DenseLeaf:
    def __init__(self, shape, device):
        self.m = torch.zeros(shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=device)
        self.g = torch.zeros(shape, dtype=torch.float32, device=device)

    def add(self, g: torch.Tensor, layer: Optional[int], b1, b2) -> None:
        if layer is None:
            self.g.copy_(g)
        else:
            self.g[layer].copy_(g)

    def step(self, p: torch.Tensor, kw, b1, b2) -> None:
        self.m.mul_(b1).add_((1.0 - b1) * self.g)
        self.v.mul_(b2).add_((1.0 - b2) * self.g * self.g)
        p.copy_(adamw(p, self.m, self.v, kw))

    def grad_norm(self, b2: float) -> float:
        return float(torch.sqrt(self.v.sum() / (1.0 - b2)))


def _now(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def bias_corrections(b1: float, b2: float, step: int):
    """(1 - b1^t, 1 - b2^t) in float32 arithmetic."""
    t, one = np.float32(step), np.float32(1.0)
    return (float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t))


def run(conf: Dict[str, Any], mix: Dict[str, Any], seed: int, hash_seed: int,
        device, steps: int, precision: str = "f32",
        fault: Optional[str] = None) -> Dict[str, Any]:
    """Follow ``steps`` training steps from the seed's weights; returns
    {"losses", "grad_norms" (leaf -> first step's), "deltas" (leaf ->
    ||p - p0|| after the steps)}.  ``fault="half_batch"``: the loss is
    the mean over the first half of the tokens alone (a check's fault)."""
    rm.strict_f32()
    mm = rm.matmul_fn(precision)
    opt = mix["optimizer"]
    b1, b2 = opt["b1"], opt["b2"]
    L = conf["num_hidden_layers"]
    eps = conf["rms_norm_eps"]
    table = weights.leaves(conf)
    order = sorted(lf.path for lf in table)       # the leaves' order
    P: Dict[str, torch.Tensor] = {}
    for lf in table:
        P[lf.path] = weights.make_leaf(lf, seed, device).float()
    state: Dict[str, Any] = {}
    for i, path in enumerate(order):
        n = P[path].numel()
        state[path] = (SketchedLeaf(n, i, opt, hash_seed, device)
                       if n >= opt["opt_state_min_elems"]
                       else DenseLeaf(P[path].shape, device))
    layer_n = {lf.path: lf.numel // lf.layers for lf in table if lf.layers}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    moments: Dict[str, Any] = {}
    parts = {"model": 0.0, "sketch_add": 0.0, "sketch_step": 0.0}
    for t in range(steps):
        for st in state.values():
            if isinstance(st, SketchedLeaf):
                st.m.mul_(b1)
                st.v.mul_(b2)

        def add(path, g, layer=None):
            t_add = _now(device)
            st = state[path]
            if isinstance(st, SketchedLeaf):
                st.add(g, 0 if layer is None else layer * layer_n[path],
                       b1, b2)
            else:
                st.add(g, layer, b1, b2)
            parts["sketch_add"] += _now(device) - t_add

        t_step = _now(device)

        tok = traffic.train_tokens(mix, conf["vocab_size"], seed, t, device)
        x_in, labels = tok[:, :-1], tok[:, 1:]
        xs = []
        with torch.no_grad():
            x = P["embed"][x_in]
            for layer in range(L):
                xs.append(x)
                x = rm.block(rm.layer_params(P, layer), x, conf, mm)
        top = {k: P[k].detach().requires_grad_() for k in
               ("final_norm", "head") if k in P}
        if conf["tie_word_embeddings"]:
            top["embed"] = P["embed"].detach().requires_grad_()
        xL = x.requires_grad_()
        h = rm.rms_norm(xL, top["final_norm"], eps)
        lg = mm(h, rm.head_weight(top, conf))
        ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1),
                             reduction="none")
        if fault == "half_batch":
            ce = ce[:ce.numel() // 2]
        loss = ce.mean()
        loss.backward()
        losses.append(float(loss.detach()))
        dx = xL.grad
        del h, lg, ce, loss, xL, x
        for k in ("final_norm", "head"):
            if k in top:
                add(k, top[k].grad)
        tied_embed = top.get("embed")
        del top
        for layer in reversed(range(L)):
            xi = xs[layer].requires_grad_()
            pl = {k: v.detach().requires_grad_()
                  for k, v in rm.layer_params(P, layer).items()}
            y = rm.block(pl, xi, conf, mm)
            y.backward(dx)
            dx = xi.grad
            for k, v in pl.items():
                add("blocks/" + k, v.grad, layer)
            xs[layer] = None
            del xi, y, pl
        d_embed = torch.zeros_like(P["embed"]).index_add_(
            0, x_in.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        if tied_embed is not None:
            d_embed += tied_embed.grad
        add("embed", d_embed)
        del d_embed, dx, tied_embed
        t_opt = _now(device)
        bc1, bc2 = bias_corrections(b1, b2, t + 1)
        kw = dict(lr=opt["lr"], eps=opt["eps"],
                  weight_decay=opt["weight_decay"], bc1=bc1, bc2=bc2)
        for path in order:
            st = state[path]
            if isinstance(st, DenseLeaf):
                st.step(P[path], kw, b1, b2)
                continue
            pieces = P[path] if path in layer_n else [P[path]]
            n_piece = layer_n.get(path, 0)
            for layer, piece in enumerate(pieces):
                st.step(piece, layer * n_piece, kw)
        t_end = _now(device)
        parts["sketch_step"] += t_end - t_opt
        parts["model"] += t_opt - t_step
        if t == 0:
            grad_norms = {p: state[p].grad_norm(b2) for p in order}
            moments = {p: project.leaf_moments(st.m, st.v, seed, p)
                       for p, st in state.items()
                       if isinstance(st, SketchedLeaf)}
    zero_v = {p: [st.zero_v[0], st.zero_v[1] / max(st.zero_v[2], 1e-300),
                  st.zero_v[3], st.zero_v[4] / max(st.zero_v[2], 1e-300)]
              for p, st in state.items() if isinstance(st, SketchedLeaf)}
    del state
    deltas = {}
    for lf in table:
        p0 = weights.make_leaf(lf, seed, device)
        deltas[lf.path] = float(torch.linalg.vector_norm(
            P[lf.path] - p0.float()))
        del p0
    parts["model"] -= parts["sketch_add"]
    return {"losses": losses, "grad_norms": grad_norms, "deltas": deltas,
            "moments": moments, "seconds": parts, "zero_v": zero_v}
