"""A configuration file (``configs/<name>.json``, the model card's keys as
they are run) as the port's ``ModelConfig``.  Only the program's side
reads this; the reference reads the file itself."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

# keys whose values the port implements only at these settings; a file
# that states another value cannot be run as stated
IDENTITY = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
            "logits_scaling": 1.0, "attention_bias": False}


def head_dim(conf: Dict[str, Any]) -> int:
    return int(conf.get("head_dim") or
               conf["hidden_size"] // conf["num_attention_heads"])


def check_runnable(conf: Dict[str, Any]) -> None:
    for k, v in IDENTITY.items():
        if k in conf and conf[k] != v:
            raise ValueError(f"{conf['name']}: {k} = {conf[k]} is not what "
                             f"the port runs ({v})")
    am = conf.get("attention_multiplier")
    if am is not None and not math.isclose(am, head_dim(conf) ** -0.5):
        raise ValueError(f"{conf['name']}: attention_multiplier {am} is not "
                         f"1/sqrt(head_dim)")


def port_config(conf: Dict[str, Any], sketch: Optional[Dict] = None,
                serve: Optional[Dict] = None):
    """The port's ModelConfig for a configuration file, with the cell's
    optimizer (``sketch``: SketchConfig fields) and engine (``serve``:
    ServeConfig fields) settings."""
    from repro_torch.configs.base import (ModelConfig, MoEConfig,
                                          ServeConfig, SketchConfig)
    check_runnable(conf)
    port = conf["port"]
    moe = None
    if port["family"] == "moe":
        moe = MoEConfig(num_experts=conf["num_local_experts"],
                        top_k=conf["num_experts_per_tok"],
                        num_shared_experts=0,
                        expert_d_ff=conf["intermediate_size"],
                        group_size=port["moe_group_size"],
                        capacity_factor=port["moe_capacity_factor"],
                        router_aux_weight=port["router_aux_weight"])
    cfg = ModelConfig(
        name=conf["name"], family=port["family"],
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        head_dim=head_dim(conf), act=conf["hidden_act"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]), moe=moe,
        source=conf["source"])
    if sketch:
        cfg = dataclasses.replace(cfg, sketch=SketchConfig(**sketch))
    if serve:
        cfg = dataclasses.replace(cfg, serve=ServeConfig(**serve))
    return cfg
