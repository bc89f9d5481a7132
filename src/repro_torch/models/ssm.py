"""State-space and recurrent sequence mixers of the port
(``repro/models/ssm.py``): Mamba-2 (SSD) for the hybrid family, mLSTM and
sLSTM for the ssm family (xLSTM).

Each block has two forms.  The full-sequence form (``state=None``) is
the training forward's and the prefill's: Mamba-2 as the chunked SSD
scan (quadratic inside chunks of ``cfg.ssm.chunk`` tokens, a recurrence
over chunks), mLSTM in its stabilised parallel form over query chunks,
sLSTM as a loop over time (its recurrence does not associate).  With
``want_state`` it also returns the state a decode step continues from.
The decode form (``state`` given, S = 1) advances that state by one token
IN PLACE: every leaf of ``state`` is a view of the engine's slot state,
stacked on a leading layer axis, at an address fixed for the engine's
life, so the decode chunk can be captured as a CUDA graph and replayed
(serve/graphs.py).  The full-sequence form returns new tensors.

The arithmetic is the reference's, operand for operand: bf16 weights and
activations, f32 gates, decays and recurrent state.  The activations'
casts follow the weights' dtype, so f32 weights (and an f32 ``init_cache``)
run the whole model in f32, the yardstick that drift is measured
against.  The reference's
three-operand einsums are ordered here as two-operand products whose
intermediates stay at (B, nc, cs, cs, H) or (B, nc, cs, H, P).  The
reference's associative scan over SSD chunks is a sequential loop here,
which adds in another order; under context sharding (the rules'
``ctx_shards`` > 1, ``fsdp_seq``) it takes the reference's two-level
order instead: a loop within each context shard's chunks, then a
prefix over the shards' totals folded into every chunk
(``_state_scan``).

Sharded (DTensor) activations follow the reference's ``shard`` sites.
The sLSTM time loop runs on each rank's own rows: its inputs are
redistributed to the batch split alone (the recurrent matrices
replicated), so no step of the loop moves data between ranks.

No TPU kernel lies on these paths: the reference computes them in plain
jnp, and the port in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ly
from repro_torch.models.sharding import (current_rules, from_local,
                                         gathered, is_dtensor, placements,
                                         shard, spec_for, to_local)

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Causal depthwise convolution
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (cw, C), b (C);
    y[t] = sum_k w[k] * x[t - (cw - 1) + k] + b, in x's dtype."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = xp[:, 0:S] * w[0]
    for k in range(1, cw):
        y = y + xp[:, k:k + S] * w[k]
    return y + b


def _conv_step(buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One decode step of the causal conv: ``buf`` (B, cw - 1, C) holds the
    past inputs oldest first and takes ``x_t`` (B, 1, C) in place.
    Returns y_t (B, 1, C)."""
    window = torch.cat([buf, x_t], dim=1)                 # (B, cw, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    buf.copy_(window[:, 1:])
    return y[:, None, :]


def _conv_stash(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width`` inputs for the decode conv buffer, LEFT-padded
    with zeros when the sequence is shorter: the window is ordered oldest
    to newest, so a short prompt's zero history sits in front."""
    stash = x[:, -width:]
    if stash.shape[1] < width:
        stash = F.pad(stash, (0, 0, width - stash.shape[1], 0))
    return stash


def layer_view(state: Optional[State], i: int) -> Optional[State]:
    """Layer ``i``'s views of a stacked (n, B, ...) state."""
    return None if state is None else {k: v[i] for k, v in state.items()}


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(di, H, P, N): inner width, SSM heads, head dim, state size."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.head_dim, s.d_state


def init_mamba2(cfg: ModelConfig, normal: Callable[..., torch.Tensor],
                uniform: Callable[..., torch.Tensor],
                dev: torch.device) -> Dict[str, torch.Tensor]:
    """One Mamba-2 layer at the reference's scales and inits: log-uniform
    dt in [0.001, 0.1) behind ``dt_bias`` = softplus^-1(dt),
    ``A_log`` = log(1..H), ``D`` = 1.  ``normal(shape, std, dtype)`` and
    ``uniform(shape)`` draw from the caller's generator."""
    d, cw = cfg.d_model, cfg.ssm.conv_width
    di, H, _, N = mamba2_dims(cfg)
    sd = 1.0 / math.sqrt(d)
    dt = torch.exp(uniform((H,)) * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    zeros = lambda n: torch.zeros((n,), dtype=ly.PDTYPE, device=dev)
    return {
        "wz": normal((d, di), sd), "wx": normal((d, di), sd),
        "wBC": normal((d, 2 * N), sd), "wdt": normal((d, H), sd),
        "conv_wx": normal((cw, di), 1.0 / math.sqrt(cw)),
        "conv_bx": zeros(di),
        "conv_wBC": normal((cw, 2 * N), 1.0 / math.sqrt(cw)),
        "conv_bBC": zeros(2 * N),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": zeros(di),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
        "pre_norm": zeros(d),
    }


def _ssd_chunked(X: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, cs: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  X: (B, S, H, P) values; dtA = dt * A (B, S, H),
    negative; dt (B, S, H); Bm, Cm (B, S, N); ``init_state`` (B, H, N, P)
    f32 or None.  Returns Y (B, S, H, P) bf16 and the final state
    (B, H, N, P) f32.  A tail short of a whole chunk is zero-padded:
    dt = 0 there, so the padded steps leave the state as it was."""
    B_, S, H, P = X.shape
    N = Bm.shape[-1]
    pad = (-S) % cs
    if pad:
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        dtA, dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad))
                           for t in (dtA, dt, Bm, Cm))
    nc = (S + pad) // cs
    wdt = X.dtype                        # the weights' dtype (bf16)
    Xt = (X * dt[..., None]).reshape(B_, nc, cs, H, P).to(wdt)
    Ac = dtA.reshape(B_, nc, cs, H).float()
    Bc = Bm.reshape(B_, nc, cs, N).to(wdt)
    Cc = Cm.reshape(B_, nc, cs, N).to(wdt)
    cum = torch.cumsum(Ac, dim=2)                           # (B, nc, cs, H)

    # intra-chunk (quadratic within a chunk):
    # Yd[i] = sum_j (C_i . B_j) L[i, j] Xt[j], L the masked decay
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)         # bf16
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,H)
    # above the diagonal ldiff > 0 grows to hundreds at full width: the
    # exponent is masked before exp (the same values as the reference's
    # where(mask, exp(ldiff), 0)), so no inf meets a zero gradient there
    mask = torch.ones(cs, cs, dtype=torch.bool, device=X.device).tril()
    L = torch.exp(ldiff.masked_fill(~mask[None, None, :, :, None],
                                    -math.inf)).to(wdt)
    L = shard(L, "batch", "chunks", None, None, "ssm_heads")
    W = scores[..., None] * L                               # (B,nc,i,j,H)
    Yd = torch.einsum("bcijh,bcjhp->bcihp", W, Xt)

    # each chunk's own state contribution and its total decay
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum).to(wdt)
    S_chunk = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                           decay_to_end[..., None] * Xt)
    S_chunk = shard(S_chunk, "batch", "chunks", "ssm_heads", None, None)
    dec = torch.exp(cum[:, :, -1, :])                       # (B, nc, H) f32

    states_in, state = _state_scan(dec, S_chunk.float(), init_state)

    # Yi[i] = exp(cum_i) * (C_i . state_in)
    Yi = torch.einsum("bcin,bchnp->bcihp", Cc, states_in.to(wdt))
    Yi = torch.exp(cum).to(wdt)[..., None] * Yi
    Y = (Yd + Yi).reshape(B_, nc * cs, H, P)[:, :S]
    return Y, state


def _state_scan(dec: torch.Tensor, s_f: torch.Tensor,
                init_state: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk recurrence state_c = state_{c-1} * dec_c + S_c in
    f32: dec (B, nc, H), s_f (B, nc, H, N, P).  Returns (states_in: the
    state entering each chunk, (B, nc, H, N, P); the final state).

    One loop over the chunks, or, with ``ctx_shards`` = ns > 1 in the
    rules and ns dividing nc (< nc), the reference's two-level order
    (``_two_level_state_scan``): each shard's ncl = nc / ns chunks from a
    zero state, with their running decay products; then the shards'
    exclusive prefix over their totals, folded into every local chunk.
    The two orders add alike in exact arithmetic."""
    B_, nc = s_f.shape[:2]
    state = (s_f.new_zeros((B_,) + tuple(s_f.shape[2:])) if init_state is None
             else init_state.float())
    ns = (current_rules() or {}).get("ctx_shards", 1)
    if ns <= 1 or nc % ns or nc == ns:
        states_in = []
        for c in range(nc):
            states_in.append(state)
            state = state * dec[:, c, :, None, None] + s_f[:, c]
        return torch.stack(states_in, dim=1), state
    ncl = nc // ns
    d2 = dec.reshape(B_, ns, ncl, *dec.shape[2:])
    s2 = s_f.reshape(B_, ns, ncl, *s_f.shape[2:])
    loc = s2.new_zeros((B_, ns) + tuple(s_f.shape[2:]))
    dcum = d2.new_ones((B_, ns) + tuple(dec.shape[2:]))
    loc_in, dec_in = [], []
    for c in range(ncl):                    # within every shard at once
        loc_in.append(loc)
        dec_in.append(dcum)
        loc = loc * d2[:, :, c, :, None, None] + s2[:, :, c]
        dcum = dcum * d2[:, :, c]
    prefix = []
    for j in range(ns):                     # across the shards' totals
        prefix.append(state)
        state = state * dcum[:, j, :, None, None] + loc[:, j]
    prefix = torch.stack(prefix, dim=1)[:, :, None]         # (B,ns,1,H,N,P)
    states_in = (torch.stack(loc_in, dim=2)
                 + prefix * torch.stack(dec_in, dim=2)[..., None, None])
    return states_in.reshape(s_f.shape), state


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[State] = None, want_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B, S, d).  With ``state`` (decode: S = 1; {"ssm": (B, H, N, P)
    f32, "conv_x": (B, cw - 1, di), "conv_BC": (B, cw - 1, 2N)}, views of
    the slot state) the step updates it in place and returns it; else
    the chunked full-sequence path runs, returning with ``want_state``
    the state after the last token."""
    s = cfg.ssm
    B, S, d = x.shape
    x = ly.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    di, H, P, N = mamba2_dims(cfg)
    z = shard(ly.linear(x, p["wz"]), "batch", "seq", "ssm_inner")
    xr = shard(ly.linear(x, p["wx"]), "batch", "seq", "ssm_inner")
    BC = ly.linear(x, p["wBC"])
    dt_raw = ly.linear(x, p["wdt"]).float()

    new_state = None
    if state is None:
        if want_state:
            cbx = _conv_stash(xr, s.conv_width - 1)
            cbc = _conv_stash(BC, s.conv_width - 1)
        xr = F.silu(_causal_conv(xr, p["conv_wx"], p["conv_bx"]))
        BC = F.silu(_causal_conv(BC, p["conv_wBC"], p["conv_bBC"]))
    else:
        xr = F.silu(_conv_step(state["conv_x"], xr, p["conv_wx"],
                               p["conv_bx"]))
        BC = F.silu(_conv_step(state["conv_BC"], BC, p["conv_wBC"],
                               p["conv_bBC"]))

    Bm, Cm = BC[..., :N], BC[..., N:]
    dt = F.softplus(dt_raw + p["dt_bias"])                  # (B, S, H) f32
    A = -torch.exp(p["A_log"])                              # (H,)
    X = shard(xr.reshape(B, S, H, P), "batch", "seq", "ssm_heads", None)

    if state is None:
        Y, final = _ssd_chunked(X, dt * A, dt, Bm, Cm, min(s.chunk, S))
        if want_state:
            new_state = {"ssm": final, "conv_x": cbx, "conv_BC": cbc}
    else:
        # one step of the recurrence: ssm = ssm * exp(dt A) + B (dt x)
        ssm = state["ssm"]                                  # (B, H, N, P)
        dA = torch.exp(dt[:, 0] * A)                        # (B, H)
        dtx = dt[:, 0, :, None] * X[:, 0].float()           # (B, H, P)
        ssm.mul_(dA[:, :, None, None]).addcmul_(
            Bm[:, 0].float()[:, None, :, None], dtx[:, :, None, :])
        Y = torch.einsum("bn,bhnp->bhp", Cm[:, 0],
                         ssm.to(Cm.dtype))[:, None]
        new_state = state

    Y = Y + X * p["D"][:, None].to(X.dtype)
    y = Y.reshape(B, S, di)
    y = ly.rms_norm((y * F.silu(z)).to(x.dtype), p["norm"], cfg.norm_eps)
    return ly.linear(y, p["out_proj"]), new_state


def init_mamba2_state(cfg: ModelConfig, n: int, batch: int,
                      dev: torch.device,
                      dtype: torch.dtype = torch.bfloat16) -> State:
    """n layers' zero Mamba-2 state, each leaf (n, batch, ...)."""
    di, H, P, N = mamba2_dims(cfg)
    cw = cfg.ssm.conv_width
    return {
        "ssm": torch.zeros((n, batch, H, N, P), dtype=torch.float32,
                           device=dev),
        "conv_x": torch.zeros((n, batch, cw - 1, di), dtype=dtype,
                              device=dev),
        "conv_BC": torch.zeros((n, batch, cw - 1, 2 * N), dtype=dtype,
                               device=dev),
    }


# ===========================================================================
# xLSTM: mLSTM
# ===========================================================================

MLSTM_CONV = 4          # the mLSTM block's causal conv width


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(dm, H, hd): up-projected width, heads, head dim."""
    dm = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    return dm, cfg.num_heads, dm // cfg.num_heads


def init_mlstm(cfg: ModelConfig, normal: Callable[..., torch.Tensor],
               dev: torch.device) -> Dict[str, torch.Tensor]:
    """One mLSTM layer at the reference's scales: dense (dm, dm) q / k /
    v, f32 gate projections with ``wf`` zero and forget bias 3 (forget
    gates open at init)."""
    d = cfg.d_model
    dm, H, _ = mlstm_dims(cfg)
    sd, sm = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dm)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "wxb": normal((d, dm), sd), "wzb": normal((d, dm), sd),
        "conv_w": normal((MLSTM_CONV, dm), 1.0 / math.sqrt(MLSTM_CONV)),
        "conv_b": torch.zeros((dm,), dtype=ly.PDTYPE, device=dev),
        "wq": normal((dm, dm), sm), "wk": normal((dm, dm), sm),
        "wv": normal((dm, dm), sm),
        "wi": normal((dm, H), sm, torch.float32),
        "wf": torch.zeros((dm, H), **f32),
        "bi": torch.zeros((H,), **f32),
        "bf": torch.full((H,), 3.0, **f32),
        "norm": torch.zeros((dm,), dtype=ly.PDTYPE, device=dev),
        "out_proj": normal((dm, d), sm),
        "pre_norm": torch.zeros((d,), dtype=ly.PDTYPE, device=dev),
    }


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[State] = None, q_chunk: int = 512,
                want_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B, S, d).  With ``state`` (decode: S = 1; {"C": (B, H, hd, hd),
    "n": (B, H, hd), "m": (B, H) f32, "conv": (B, 3, dm)}, views of the
    slot state) the recurrent step updates it in place; else the parallel
    form runs over query chunks of min(``q_chunk``, S) rows and, with
    ``want_state``, derives the state after the last token in closed
    form."""
    B, S, d = x.shape
    x = ly.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    dm, H, hd = mlstm_dims(cfg)
    xb = shard(ly.linear(x, p["wxb"]), "batch", "seq", "ssm_inner")
    zb = ly.linear(x, p["wzb"])
    if state is None:
        xc = F.silu(_causal_conv(xb, p["conv_w"], p["conv_b"]))
    else:
        xc = F.silu(_conv_step(state["conv"], xb, p["conv_w"], p["conv_b"]))

    # a sharded inner dim splits into (H, hd) only where the heads do
    heads = lambda t: shard(t, "batch", "seq", "heads").reshape(B, S, H, hd)
    q = heads(ly.linear(xc, p["wq"]))
    k = heads(ly.linear(xc, p["wk"])) / math.sqrt(hd)
    v = heads(ly.linear(xb, p["wv"]))
    xcf = xc.float()
    i_pre = ly.linear(xcf, p["wi"]) + p["bi"]                         # (B, S, H)
    f_pre = ly.linear(xcf, p["wf"]) + p["bf"]
    logf = -F.softplus(-f_pre)                              # log sigmoid

    new_state = None
    if state is None:
        h = _mlstm_parallel(q, k, v, i_pre, logf, min(q_chunk, S))
        if want_state:
            b = torch.cumsum(logf, dim=1)                   # (B, S, H)
            dexp = b[:, -1:, :] - b + i_pre
            m_fin = dexp.amax(dim=1)                        # (B, H)
            w = torch.exp(dexp - m_fin[:, None, :])         # (B, S, H)
            kf, vf = k.float(), v.float()
            wk = (w[..., None] * kf).permute(0, 2, 3, 1)    # (B, H, hd, S)
            C_fin = wk @ vf.permute(0, 2, 1, 3)             # (B, H, hd, hd)
            n_fin = torch.einsum("bsh,bshp->bhp", w, kf)
            new_state = {"C": C_fin, "n": n_fin, "m": m_fin,
                         "conv": _conv_stash(xb, MLSTM_CONV - 1)}
    else:
        C, n, m = state["C"], state["n"], state["m"]        # f32
        i_t, lf_t = i_pre[:, 0], logf[:, 0]                 # (B, H)
        m_new = torch.maximum(lf_t + m, i_t)
        fd = torch.exp(lf_t + m - m_new)[..., None]         # (B, H, 1)
        idg = torch.exp(i_t - m_new)[..., None]
        kf, vf, qf = (t[:, 0].float() for t in (k, v, q))   # (B, H, hd)
        ik = idg * kf
        # C = C * fd + (idg k) v^T, n = n * fd + idg k: in place
        C.mul_(fd[..., None]).addcmul_(ik[..., :, None], vf[..., None, :])
        n.mul_(fd).add_(ik)
        m.copy_(m_new)
        num = (qf[:, :, None, :] @ C)[:, :, 0]              # (B, H, hd)
        den = torch.maximum((qf * n).sum(-1).abs(), torch.exp(-m_new))
        h = (num / den[..., None])[:, None].to(x.dtype)     # (B, 1, H, hd)
        new_state = state

    h = h.reshape(B, S, dm)
    h = ly.rms_norm(h, p["norm"], cfg.norm_eps) * F.silu(zb)
    return ly.linear(h, p["out_proj"]), new_state


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, logf: torch.Tensor,
                    qc: int) -> torch.Tensor:
    """Stabilised parallel mLSTM over query chunks of ``qc`` rows.
    q, k, v: (B, S, H, hd) bf16; i_pre, logf: (B, S, H) f32.  Returns
    h (B, S, H, hd) bf16."""
    B, S, H, hd = q.shape
    b = torch.cumsum(logf, dim=1)                           # (B, S, H)
    kT = k.permute(0, 2, 3, 1)                              # (B, H, hd, S)
    vh = v.permute(0, 2, 1, 3)                              # (B, H, S, hd)
    bk = b.permute(0, 2, 1)[:, :, None, :]                  # (B, H, 1, S)
    ik = i_pre.permute(0, 2, 1)[:, :, None, :]
    # under autograd each chunk is recomputed in the backward, as the
    # reference's jax.checkpoint per chunk: its (B, H, r, S) products are
    # never all held at once
    grad = torch.is_grad_enabled()
    out = []
    for q0 in range(0, S, qc):
        rows = min(qc, S - q0)
        qi = q[:, q0:q0 + rows].permute(0, 2, 1, 3)         # (B, H, r, hd)
        bq = b[:, q0:q0 + rows].permute(0, 2, 1)            # (B, H, r)
        if grad:
            h = checkpoint(_mlstm_chunk, qi, bq, bk, ik, kT, vh, q0,
                           use_reentrant=False)
        else:
            h = _mlstm_chunk(qi, bq, bk, ik, kT, vh, q0)
        out.append(h)
    return torch.cat(out, dim=1)


def _mlstm_chunk(qi: torch.Tensor, bq: torch.Tensor, bk: torch.Tensor,
                 ik: torch.Tensor, kT: torch.Tensor, vh: torch.Tensor,
                 q0: int) -> torch.Tensor:
    """One query chunk of ``_mlstm_parallel``: rows q0 .. q0 + r of the
    queries qi (B, H, r, hd) with their cumulative log forget gates bq
    (B, H, r), against every key's cumulative log forget gate bk and
    input gate ik (B, H, 1, S), kT (B, H, hd, S) and vh (B, H, S, hd).
    Returns h (B, r, H, hd)."""
    rows, S = qi.shape[2], kT.shape[-1]
    causal = (q0 + torch.arange(rows, device=qi.device))[:, None] \
        >= torch.arange(S, device=qi.device)[None, :]       # (r, S)
    Dm = (bq[..., None] - bk + ik).masked_fill(~causal, -math.inf)
    m = Dm.amax(dim=-1)                                     # (B, H, r)
    Dp = torch.exp(Dm - m[..., None]).to(qi.dtype)
    w = (qi @ kT) * Dp                                      # (B, H, r, S)
    num = w @ vh                                            # (B, H, r, hd)
    den = torch.maximum(w.float().sum(-1).abs(), torch.exp(-m))
    return (num / den[..., None].to(num.dtype)).permute(0, 2, 1, 3)


def init_mlstm_state(cfg: ModelConfig, n: int, batch: int,
                     dev: torch.device,
                     dtype: torch.dtype = torch.bfloat16) -> State:
    """n layers' zero mLSTM state, each leaf (n, batch, ...); the
    stabiliser ``m`` starts at 0, as the reference's."""
    dm, H, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "C": torch.zeros((n, batch, H, hd, hd), **f32),
        "n": torch.zeros((n, batch, H, hd), **f32),
        "m": torch.zeros((n, batch, H), **f32),
        "conv": torch.zeros((n, batch, MLSTM_CONV - 1, dm), dtype=dtype,
                            device=dev),
    }


# ===========================================================================
# xLSTM: sLSTM
# ===========================================================================

SLSTM_GATES = ("i", "f", "z", "o")


def _slstm_up_dim(cfg: ModelConfig) -> int:
    """4/3 d rounded to a multiple of 128: the post-GLU's width."""
    return max(128, int(round(cfg.xlstm.proj_factor_s * cfg.d_model / 128))
               * 128)


def init_slstm(cfg: ModelConfig, normal: Callable[..., torch.Tensor],
               dev: torch.device) -> Dict[str, torch.Tensor]:
    """One sLSTM layer at the reference's scales: per gate an input
    projection (d, d), a block-diagonal recurrent matrix (H, hd, hd) and
    an f32 bias (1 for the forget gate), then the post up/down GLU."""
    d, H = cfg.d_model, cfg.num_heads
    hd, ds = d // H, _slstm_up_dim(cfg)
    sd, sh = 1.0 / math.sqrt(d), 1.0 / math.sqrt(hd)
    p = {}
    for g in SLSTM_GATES:
        p[f"w{g}"] = normal((d, d), sd)
        p[f"r{g}"] = normal((H, hd, hd), sh)
        p[f"b{g}"] = torch.full((d,), 1.0 if g == "f" else 0.0,
                                dtype=torch.float32, device=dev)
    p["norm"] = torch.zeros((d,), dtype=ly.PDTYPE, device=dev)
    p["pre_norm"] = torch.zeros((d,), dtype=ly.PDTYPE, device=dev)
    p["w_up_g"] = normal((d, ds), sd)
    p["w_up"] = normal((d, ds), sd)
    p["w_down"] = normal((ds, d), 1.0 / math.sqrt(ds))
    return p


def _slstm_cell(p: dict, c: torch.Tensor, n: torch.Tensor, h: torch.Tensor,
                m: torch.Tensor, pre: Dict[str, torch.Tensor]):
    """One timestep.  c, n, h, m: (B, H, hd) f32; ``pre``: each gate's
    input preactivation at t, (B, H, hd) f32.  Returns (c, n, h, m)."""
    hb = h.to(p["ri"].dtype).transpose(0, 1)                # (H, B, hd)
    rec = {g: (hb @ p[f"r{g}"]).transpose(0, 1).float()
           for g in SLSTM_GATES}
    it = pre["i"] + rec["i"]
    ft = pre["f"] + rec["f"]
    zt = torch.tanh(pre["z"] + rec["z"])
    ot = torch.sigmoid(pre["o"] + rec["o"])
    logf = -F.softplus(-ft)
    m_new = torch.maximum(logf + m, it)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(it - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    # maximum, not clamp: the same values, and at n == 1 (every unit
    # whose first input gate leads its forget gate) the gradient splits
    # as the reference's jnp.maximum splits it
    h = ot * c / torch.maximum(n, n.new_ones(()))
    return c, n, h, m_new


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[State] = None, want_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (B, S, d).  The cell runs over time from ``state`` ({"c", "n",
    "h", "m"}: (B, H, hd) f32 views of the slot state; decode, S = 1,
    updated in place) or from zeros (full sequence; with ``want_state``
    the final carry is returned as a new state)."""
    B, S, d = x.shape
    x = ly.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    H = cfg.num_heads
    hd = d // H
    pre = {g: shard(ly.linear(x, p[f"w{g}"]).float() + p[f"b{g}"], "batch", "seq",
                    "heads").reshape(B, S, H, hd)
           for g in SLSTM_GATES}
    if state is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        carry = (z, z, z, z)
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    if state is None and is_dtensor(x):
        y, carry = _slstm_sharded(p, pre, carry)
    else:
        y, carry = _slstm_loop(p, pre, carry)
    y = y.reshape(B, S, d).to(x.dtype)
    y = ly.rms_norm(y, p["norm"], cfg.norm_eps)
    g = ly.linear(y, p["w_up_g"])
    u = ly.linear(y, p["w_up"])
    out = ly.linear(F.gelu(g, approximate="tanh") * u, p["w_down"])
    new_state = None
    if state is not None:
        for key, val in zip(("c", "n", "h", "m"), carry):
            state[key].copy_(val)
        new_state = state
    elif want_state:
        new_state = dict(zip(("c", "n", "h", "m"), carry))
    return out, new_state


def _slstm_loop(p: dict, pre: Dict[str, torch.Tensor], carry: tuple):
    """The sLSTM time loop: h (B, S, H, hd) f32 and the final carry."""
    hs = []
    for t in range(pre["i"].shape[1]):
        carry = _slstm_cell(p, *carry, {g: pre[g][:, t] for g in pre})
        hs.append(carry[2])
    return torch.stack(hs, dim=1), carry


def _slstm_sharded(p: dict, pre: Dict[str, torch.Tensor], carry: tuple):
    """``_slstm_loop`` on DTensors from a zero carry: each rank runs the
    loop on its own batch rows, the preactivations split over the batch
    axis alone and the recurrent matrices replicated (gathered once, not
    once a step); h comes back split the same way."""
    rows = spec_for(("batch", None, None, None))
    mesh = pre["i"].device_mesh
    pl = placements(rows, mesh)
    lp = {f"r{g}": gathered(p[f"r{g}"], pl) for g in SLSTM_GATES}
    lpre = {g: to_local(v, rows) for g, v in pre.items()}
    z = torch.zeros_like(lpre["i"][:, 0])
    h, carry = _slstm_loop(lp, lpre, (z, z, z, z))
    return (from_local(h, mesh, rows),
            tuple(from_local(c, mesh, rows[:3]) for c in carry))


def init_slstm_state(cfg: ModelConfig, n: int, batch: int,
                     dev: torch.device) -> State:
    """n layers' zero sLSTM state, each leaf (n, batch, H, hd) f32."""
    H = cfg.num_heads
    shape = (n, batch, H, cfg.d_model // H)
    return {k: torch.zeros(shape, dtype=torch.float32, device=dev)
            for k in ("c", "n", "h", "m")}
