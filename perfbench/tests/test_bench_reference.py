"""The reference agrees with the port's CPU path at small widths (the
tests may import the port; the reference itself does not)."""
import numpy as np
import pytest
import tiny
import torch

from perfbench import weights
from perfbench.reference import hashing
from perfbench.reference import model as rm
from perfbench.reference import train as ref_train


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 5])
def test_hashes_bitwise_the_ports(seed):
    from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs
    co = hashing.coeffs(seed, 3)
    assert np.array_equal(co.astype(np.int64),
                          cached_coeffs(seed, 3).numpy())
    idx = torch.cat([torch.arange(5000), torch.tensor(
        [2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1, 2_159_000_000])])
    C = 180_355_072
    bk, sg = row_buckets_signs(cached_coeffs(seed, 3), idx, C, True)
    x32 = hashing.u32_bits(idx)
    bks, sgs = hashing.row_hashes(co, x32, C, True)
    for r in range(3):
        assert torch.equal(bks[r], bk[r].long())
        assert torch.equal(sgs[r], sg[r])
        a, b, sa, sb = (int(v) for v in co[r])
        assert torch.equal(hashing.bucket_exact(idx, a, b, C), bk[r].long())
    hashing.check_fast_form(co, C, 2 ** 32 - 1, "cpu")


def test_sketched_adamw_matches_the_ports_plain_version():
    from repro_torch.kernels import ref as kref
    from repro_torch.sketch.hashing import cached_coeffs
    opt = dict(opt_state_rows=3, opt_state_ratio=4)
    n, off, i, seed = 6000, 1000, 5, 99
    leaf = ref_train.SketchedLeaf(n + off, i, opt, seed, "cpu")
    g = torch.randn(n, generator=torch.Generator().manual_seed(1))
    p = torch.randn(n, generator=torch.Generator().manual_seed(2))
    cm = cached_coeffs(hashing.leaf_seed(seed, 2 * i), 3)
    cv = cached_coeffs(hashing.leaf_seed(seed, 2 * i + 1), 3)
    zeros = torch.zeros_like(leaf.m)
    new_m, new_v = kref.sketch_accumulate_ref([(g, off)], zeros, zeros, cm,
                                              cv, 0.9, 0.95)
    leaf.add(g, off, 0.9, 0.95)
    torch.testing.assert_close(leaf.m, new_m, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(leaf.v, new_v, rtol=1e-6, atol=1e-7)
    kw = dict(lr=3e-4, eps=1e-8, weight_decay=0.01, bc1=0.1, bc2=0.05)
    want = p.clone()
    kref.sketch_step_ref([(g, off)], [want], new_m, new_v, cm, cv, **kw)
    got = p.clone()
    leaf.step(got, off, kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_reference_loss_matches_the_ports():
    from repro_torch.models import transformer as tf

    from perfbench.model_config import port_config
    name, conf, mix = tiny.train_cell()
    seed = 5
    params = weights.port_params(conf, seed, "cpu")
    tok = torch.randint(0, conf["vocab_size"], (1, 33),
                        generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    port = float(tf.loss_fn(params, batch, port_config(conf)))
    P = {lf.path: t.float() for lf, t in weights.iter_leaves(conf, seed,
                                                             "cpu")}
    x = P["embed"][batch["tokens"]]
    for layer in range(conf["num_hidden_layers"]):
        x = rm.block(rm.layer_params(P, layer), x, conf, torch.matmul)
    lg = rm.rms_norm(x, P["final_norm"], conf["rms_norm_eps"]) @ P["head"]
    ref = float(torch.nn.functional.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), batch["labels"].reshape(-1)))
    assert abs(port - ref) / ref < 2e-3


def test_reference_moe_matches_the_ports_dropless_layer():
    import dataclasses

    from repro_torch.models import moe

    from perfbench.model_config import port_config
    name, conf, mix = tiny.serve_cell()
    cfg = port_config(conf)
    # capacity above every count: the port's layer drops nothing
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=100.0))
    P = {lf.path: t for lf, t in weights.iter_leaves(conf, 3, "cpu")}
    p = {k[len("blocks/moe/"):]: v[0] for k, v in P.items()
         if k.startswith("blocks/moe/")}
    x = torch.randn(1, 40, conf["hidden_size"],
                    generator=torch.Generator().manual_seed(4)).to(
                        torch.bfloat16)
    port = moe.moe_ffn(p, x, cfg).float()
    ref = rm.moe({k: v.float() for k, v in p.items()}, x.float(), conf,
                 torch.matmul)
    assert float((port - ref).abs().max()) < 0.02 * float(ref.abs().max())


def test_requests_judged_together_match_each_alone():
    """The serving reference's batched forward: each request attends only
    to itself, so two together give each one's logits alone."""
    name, conf, mix = tiny.serve_cell()
    P = {lf.path: t.float() for lf, t in weights.iter_leaves(conf, 3, "cpu")}
    g = torch.Generator().manual_seed(6)
    seqs = [torch.randint(0, conf["vocab_size"], (n,), generator=g)
            for n in (23, 40)]
    rows = [torch.arange(n - 5, n) for n in (23, 40)]
    both = rm.logits_many(P, seqs, conf, torch.matmul, rows)
    for t, r, lg in zip(seqs, rows, both):
        alone = rm.logits(P, t, conf, torch.matmul, r)
        torch.testing.assert_close(lg, alone, rtol=1e-5, atol=1e-5)
