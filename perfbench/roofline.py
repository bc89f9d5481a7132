"""The benchmark's own arithmetic: the card's peaks, model FLOPs, and the
least bytes of the kernels whose roofline shares it reports.  Fed by the
configuration files and the traffic, never by the program's counters.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
The byte counts are copies of the port's chip smoke run's arithmetic
(each input read once and each output written once)."""
from __future__ import annotations

from typing import Any, Dict

from perfbench import weights
from perfbench.reference import hashing

BF16_FLOPS = 989e12              # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12        # HBM3 bytes/s


def head_dim(conf: Dict[str, Any]) -> int:
    return conf.get("head_dim") or conf["hidden_size"] // conf[
        "num_attention_heads"]


def matmul_params(conf: Dict[str, Any], active: bool) -> int:
    """Weights that a token multiplies (the embedding is a lookup): every
    layer's, with ``active`` only its top-k experts, and the head."""
    n = 0
    E = conf.get("num_local_experts", 0)
    K = conf.get("num_experts_per_tok", 0)
    for lf in weights.leaves(conf):
        if lf.path in ("embed", "final_norm") or "norm" in lf.path:
            continue
        size = lf.numel
        if active and lf.path.startswith("blocks/moe/we_"):
            size = size // E * K
        n += size
    if conf["tie_word_embeddings"]:
        n += weights.padded_vocab(conf) * conf["hidden_size"]
    return n


def attention_flops(conf: Dict[str, Any], context: float) -> float:
    """Forward FLOPs of one token's scores and weighted sum over
    ``context`` keys, every layer."""
    return (4.0 * conf["num_attention_heads"] * head_dim(conf) * context
            * conf["num_hidden_layers"])


def train_step_flops(conf: Dict[str, Any], batch: int, seq: int) -> float:
    """6 N T plus causal attention (mean context (seq + 1) / 2), forward
    and backward."""
    T = batch * seq
    return 6.0 * matmul_params(conf, active=True) * T + 3.0 * T * \
        attention_flops(conf, (seq + 1) / 2.0)


def forward_token_flops(conf: Dict[str, Any], context: float) -> float:
    return 2.0 * matmul_params(conf, active=True) + attention_flops(
        conf, context)


def sketched_adamw_bytes(conf: Dict[str, Any], opt: Dict[str, Any]) -> int:
    """Least bytes of one sketched AdamW step (the fused form): for each
    sketched leaf its bf16 gradient read once, both tables read and
    written once, its bf16 params read and written once; for each dense
    leaf the AdamW step's gradient and params, and its f32 moments read
    and written once."""
    total = 0
    R = opt["opt_state_rows"]
    for lf in weights.leaves(conf):
        n, item = lf.numel, lf.dtype.itemsize
        if n >= opt["opt_state_min_elems"]:
            C = hashing.cols_for(n, opt["opt_state_ratio"], R)
            total += n * item + 2 * 2 * R * C * 4 + 2 * n * item
        else:
            total += n * item + 2 * n * item + 2 * 2 * n * 4
    return total


def kv_row_bytes(conf: Dict[str, Any]) -> int:
    """Bytes of one token's K and V rows over every layer (bf16 pool)."""
    return (2 * conf["num_key_value_heads"] * head_dim(conf) * 2
            * conf["num_hidden_layers"])


def least_ms(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
