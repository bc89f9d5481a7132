"""The plain reference of the models the benchmark runs: a decoder of
RMSNorm, rotary GQA attention with a causal mask, and a SwiGLU MLP or a
dropless top-k mixture of SwiGLU experts, in float32 with TF32 off and no
kernel, cache or batching of the program.

It follows the model card as the program runs it (``configs/*.json``):
the norm gain is ``1 + scale`` (the program's parametrisation), scores
are scaled by 1/sqrt(head_dim), the experts' outputs are weighted by the
renormalised top-k router probabilities.  Where the program's MoE drops
a choice past an expert's capacity, this reference serves every choice:
the card's model is dropless.

``precision="fp8"`` is the control, a product computed in float8 as fp8
training computes it: every matrix product takes its two operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude to
448), products summed in float32; in the backward the gradient reaching
the product is rounded to e5m2 the same way (largest magnitude to
57344), so both backward products take float8 operands too, and the
rounding of the operands passes the gradient straight through.  Nothing
here imports the program.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                  # e4m3
FP8_GRAD_MAX = 57344.0           # e5m2


def strict_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_GRAD_MAX)


def matmul_fn(precision: str) -> Callable:
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: _Fp8Grad.apply(torch.matmul(_Fp8.apply(a),
                                                        _Fp8.apply(b)))
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, n, hd) at positions 0..S-1, halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
              conf: Dict[str, Any], mm: Callable) -> torch.Tensor:
    B, S, d = x.shape
    H, K = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    q = rope(mm(x, p["wq"]).view(B, S, H, hd), conf["rope_theta"])
    k = rope(mm(x, p["wk"]).view(B, S, K, hd), conf["rope_theta"])
    v = mm(x, p["wv"]).view(B, S, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, S, hd)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(B, S, H * hd), p["wo"])


def glu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
        wd: torch.Tensor, mm: Callable) -> torch.Tensor:
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict[str, Any],
        mm: Callable) -> torch.Tensor:
    """Dropless top-k experts: softmax over the router's logits, the k
    largest (ties to the lower expert), their probabilities renormalised
    to sum to one, each expert's SwiGLU weighted by them."""
    B, S, d = x.shape
    E, K = conf["num_local_experts"], conf["num_experts_per_tok"]
    xs = x.reshape(B * S, d)
    probs = torch.softmax(mm(xs, p["router"]), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw = srt.values[:, :K]
    topw = topw / topw.sum(-1, keepdim=True)
    topi = srt.indices[:, :K]
    out = torch.zeros_like(xs)
    for e in range(E):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = glu(xs[tok], p["we_gate"][e], p["we_up"][e], p["we_down"][e], mm)
        out = out.index_add(0, tok, y * topw[tok, slot][:, None])
    return out.view(B, S, d)


def mixer(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict[str, Any],
          mm: Callable) -> torch.Tensor:
    """A layer's attention with its residual: ``x`` (B, S, d) rows of one
    sequence each."""
    a = {k[5:]: v for k, v in p.items() if k.startswith("attn/")}
    return x + attention(a, rms_norm(x, p["norm1"], conf["rms_norm_eps"]),
                         conf, mm)


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict[str, Any],
        mm: Callable) -> torch.Tensor:
    """A layer's MLP or experts with its residual, row by row: ``x``
    (B, S, d) may hold rows of many sequences."""
    h = rms_norm(x, p["norm2"], conf["rms_norm_eps"])
    if conf["port"]["family"] == "moe":
        return x + moe({k[4:]: v for k, v in p.items()
                        if k.startswith("moe/")}, h, conf, mm)
    return x + glu(h, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"], mm)


def block(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict[str, Any],
          mm: Callable) -> torch.Tensor:
    """One decoder layer; ``p`` maps the port's names below "blocks/"
    ("attn/wq", "norm1", "ffn/w_gate" or "moe/router", ...) to this
    layer's tensors."""
    return ffn(p, mixer(p, x, conf, mm), conf, mm)


def head_weight(P: Dict[str, torch.Tensor], conf: Dict[str, Any]):
    return P["embed"].t() if conf["tie_word_embeddings"] else P["head"]


def layer_params(P: Dict[str, torch.Tensor], layer: int
                 ) -> Dict[str, torch.Tensor]:
    return {k[len("blocks/"):]: v[layer] for k, v in P.items()
            if k.startswith("blocks/")}


@torch.no_grad()
def logits(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
           conf: Dict[str, Any], mm: Callable,
           rows: torch.Tensor) -> torch.Tensor:
    """Float32 logits (n, vocab_size) at positions ``rows`` of one
    sequence ``tokens`` (S,): the full forward over all of it."""
    return logits_many(P, [tokens], conf, mm, [rows])[0]


@torch.no_grad()
def logits_many(P: Dict[str, torch.Tensor], seqs: List[torch.Tensor],
                conf: Dict[str, Any], mm: Callable,
                rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """``logits`` of several sequences at once: each attends only to
    itself, and the row-wise parts (MLP, experts, head) take the rows of
    all of them in one call."""
    xs = [P["embed"][t][None] for t in seqs]
    lens = [t.numel() for t in seqs]
    for layer in range(conf["num_hidden_layers"]):
        p = layer_params(P, layer)
        x = torch.cat([mixer(p, x, conf, mm) for x in xs], dim=1)
        xs = list(ffn(p, x, conf, mm).split(lens, dim=1))
    h = torch.cat([x[0, r] for x, r in zip(xs, rows)])
    h = rms_norm(h, P["final_norm"], conf["rms_norm_eps"])
    lg = mm(h, head_weight(P, conf))[:, :conf["vocab_size"]]
    return list(lg.split([r.numel() for r in rows]))
