"""Where a moe model's kernel-path logits drift from its plain path's, on
one card.

    python3 tools/moe_drift.py [--arch deepseek-moe-16b] [--depths 8,16,28]
        [--out chiprun_out/moe_drift.json]

Builds the config at full width (random weights from ``chip_smoke.py``'s
seed) and its ``logit_parity`` inputs (``parity_inputs``: a decode step of
8 slots and a 32-row chunk over one prefilled paged cache), and runs six
paths over them:

  f32      the plain path in f32: the same bf16 weights and cache read as
           f32 (converted a layer at a time), f32 activations, softmax
           weights and combine weights; its own routing
  kernel   the kernel path (bf16, the paged_attention kernel), own routing
  plain    the plain path (bf16, the kernel's plain version), own routing
  kernel@f32, plain@f32   each forced onto the f32 path's experts
                          (models/routing.py)
  plain@kernel            the plain path forced onto the kernel path's
                          experts, as chip_smoke.py's check runs it

At full depth it records each layer's residual stream (the output of
``_ffn_residual``) on the live rows and prints, per layer, max|dh| against
the f32 path as a fraction of the f32 path's max|h| (decode and chunk),
and the rows whose experts differ from the f32 path's.  At each depth it
prints each path's logits against the f32 path's and the kernel path's
against the plain path's, as % of max|logit|.  Writes every number to
``--out`` as JSON.  Builds the kernels first.  ``--device cpu
--reduced`` runs the reduced config on the CPU (the kernel path is then
the plain path) to try the script.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HOME, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


class F32Blocks:
    """The blocks of a parameter tree read as f32, a layer at a time."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __len__(self):
        return len(self.blocks)

    def __getitem__(self, i):
        import torch
        from repro_torch.models import transformer as tf
        if isinstance(i, slice):
            return F32Blocks(self.blocks[i])
        return tf.tree_map(lambda t: t.to(torch.float32), self.blocks[i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--depths", default="8,16,28")
    ap.add_argument("--out", default=os.path.join(HOME, "chiprun_out",
                                                  "moe_drift.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HOME, "src"))
    cs = load_smoke()
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.kernels import build
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    from repro_torch.models.routing import RoutingProbe
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "cpu"
    if dev.type == "cuda":
        build.build_all()
        card = cs.card()
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    depths = [int(d) for d in args.depths.split(",")]
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=cs.SEED, device=dev)
    inp = cs.parity_inputs(cfg, params, dev)
    p32 = {k: (F32Blocks(v) if k == "blocks" else
               None if v is None else v.to(torch.float32))
           for k, v in params.items()}
    inp32 = dict(inp, cache={"kv": {k: v.float() for k, v in
                                    inp["cache"]["kv"].items()}})
    B = inp["cur"].shape[0]
    S = inp["chunk"].shape[1]
    orig = tf._ffn_residual
    hidden = {}

    def recording(p_l, x, c, live=None, layer=0, positions=None, slab=None):
        out = orig(p_l, x, c, live, layer, positions, slab)
        rows = B if live == (B, 1) else S
        hidden.setdefault(layer, []).append(out[:rows].float().reshape(
            rows, -1))
        return out

    def run(name, depth, forced=None, record=False):
        """(decode logits, chunk logits, probe, {layer: [h_decode,
        h_chunk]})"""
        f32 = name == "f32"
        hidden.clear()
        tf._ffn_residual = recording if record else orig
        if f32:
            ly.PDTYPE = torch.float32
        try:
            with torch.no_grad(), RoutingProbe(forced) as probe:
                lg = cs.parity_logits(cfg, p32 if f32 else params,
                                      inp32 if f32 else inp,
                                      False if name != "kernel" else None,
                                      blocks=depth)
        finally:
            tf._ffn_residual = orig
            ly.PDTYPE = torch.bfloat16
        return lg[0].float(), lg[1].float(), probe, dict(hidden)

    def pct(a, b):
        return 100.0 * (a - b).abs().max().item() / b.abs().max().item()

    def flips(probe, ref):
        """Rows whose expert set differs from ``ref``'s, per layer."""
        out = {}
        for a, b in zip(probe.calls, ref.calls):
            d = (a.topi.sort(-1).values != b.topi.sort(-1).values).any(-1)
            out[a.layer] = out.get(a.layer, 0) + int(d.sum())
        return out

    record = {"arch": args.arch, "card": card, "layers": L,
              "depths": {}, "per_layer": []}
    for depth in depths:
        full = depth == L
        r = {"f32": run("f32", depth, record=full)}
        own = r["f32"][2].forcing()
        r["kernel"] = run("kernel", depth, record=full)
        r["plain"] = run("plain", depth, record=full)
        r["kernel@f32"] = run("kernel", depth, own, record=full)
        r["plain@f32"] = run("plain", depth, own, record=full)
        r["plain@kernel"] = run("plain", depth, r["kernel"][2].forcing())
        ref = r["f32"]
        row = {}
        for name, v in r.items():
            row[name] = {"decode_pct_vs_f32": pct(v[0], ref[0]),
                         "chunk_pct_vs_f32": pct(v[1], ref[1]),
                         "worst": v[2].worst, "differ": v[2].differ,
                         "rows": v[2].rows}
        for a, b in (("kernel", "plain"), ("kernel", "plain@kernel"),
                     ("kernel@f32", "plain@f32")):
            row[f"{a} vs {b}"] = {
                "decode_pct": pct(r[a][0], r[b][0]),
                "chunk_pct": pct(r[a][1], r[b][1])}
        row["flips_vs_f32"] = {n: sum(flips(r[n][2], ref[2]).values())
                               for n in ("kernel", "plain")}
        row["flips_kernel_vs_plain"] = sum(
            flips(r["kernel"][2], r["plain"][2]).values())
        record["depths"][depth] = row
        print(f"[drift] {args.arch} depth {depth}: logits as % of "
              f"max|logit| (decode / chunk): "
              + "; ".join(f"{n} vs f32 {row[n]['decode_pct_vs_f32']:.3f} / "
                          f"{row[n]['chunk_pct_vs_f32']:.3f}"
                          for n in r if n != "f32")
              + "; " + "; ".join(
                  f"{k} {v['decode_pct']:.3f} / {v['chunk_pct']:.3f}"
                  for k, v in row.items() if " vs " in k)
              + f"; rows routed apart from f32 (all layers) kernel "
              f"{row['flips_vs_f32']['kernel']}, plain "
              f"{row['flips_vs_f32']['plain']}, kernel vs plain "
              f"{row['flips_kernel_vs_plain']}; forced runs' worst gap "
              + ", ".join(f"{n} {row[n]['worst']:.4f} ({row[n]['differ']}/"
                          f"{row[n]['rows']} rows)" for n in r if "@" in n)
              + f"; {card}", flush=True)
        if not full:
            continue
        fk, fp = flips(r["kernel"][2], ref[2]), flips(r["plain"][2], ref[2])
        for layer in range(L):
            h32 = ref[3][layer]
            e = {"layer": layer, "flips_kernel": fk.get(layer, 0),
                 "flips_plain": fp.get(layer, 0)}
            for name in ("kernel", "plain", "kernel@f32", "plain@f32"):
                hs = r[name][3][layer]
                e[name] = [((h - h0).abs().max() / h0.abs().max()).item()
                           for h, h0 in zip(hs, h32)]
            record["per_layer"].append(e)
            print(f"[drift] {args.arch} layer {layer}: max|dh| / max|h| vs "
                  f"f32 (decode, chunk): "
                  + "; ".join(f"{n} {e[n][0]:.3e}, {e[n][1]:.3e}"
                              for n in ("kernel", "plain", "kernel@f32",
                                        "plain@f32"))
                  + f"; rows routed apart from f32: kernel "
                  f"{e['flips_kernel']}, plain {e['flips_plain']}",
                  flush=True)
    record["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[drift] {args.arch} done in {record['seconds']:.1f}s; "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
