"""Port parity: the plain PyTorch paged attention of ``repro_torch``
against the JAX package's oracle and its Pallas kernel (interpret mode,
as tests/test_kernels.py runs it on the CPU), plus the op's device
dispatch.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).

Tolerance: rtol 1e-5 / atol 1e-6 on (m, l, acc).  Both sides walk the
same blocks with the same update equations from the same bf16 inputs;
bf16 x bf16 products are exact in f32, so only the f32 summation order
inside each dot product differs (~1e-7 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import SlotScheduler

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

# (B, Sq, K, R, hd, NB, bs, nb): decode-, verify- and chunk-shaped cases
# (the geometries of tests/test_kernels.py PAGED_SHAPES)
PAGED_SHAPES = [
    (3, 1, 2, 3, 16, 12, 8, 4),     # single-token decode, GQA
    (2, 4, 2, 2, 32, 10, 4, 5),     # multi-query (C = 4)
    (1, 16, 1, 4, 16, 8, 8, 6),     # chunked prefill (one slot), MQA
    (4, 3, 3, 1, 8, 20, 16, 3),     # R == 1
]


def _paged_inputs(B, Sq, K, R, hd, NB, bs, nb, seed=0):
    """Ragged geometry as in tests/test_kernels.py: per-slot starts, slot
    0's last table entry invalidated, fold_base mixing 0 and bs."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, K, R, hd).astype(np.float32)
    kp = rng.randn(NB, bs, K, hd).astype(np.float32)
    vp = rng.randn(NB, bs, K, hd).astype(np.float32)
    tables = (rng.permutation(NB)[:B * nb].reshape(B, nb) if B * nb <= NB
              else rng.randint(0, NB, (B, nb))).astype(np.int32)
    tables[0, nb - 1] = NB
    start = rng.randint(0, nb * bs - Sq, (B,)).astype(np.int32)
    fb = np.minimum(np.array([0] * (B - B // 2) + [bs] * (B // 2),
                             np.int32), start)
    return q, kp, vp, tables, start, fb


def _jax(args):
    q, kp, vp, tables, start, fb = args
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
            jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
            jnp.asarray(start), jnp.asarray(fb))


def _torch(args, device="cpu"):
    q, kp, vp, tables, start, fb = args
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, kp, vp)]
    ints = [torch.as_tensor(a) for a in (tables, start, fb)]
    return [t.to(device) for t in bf + ints]


def _close(got, want):
    for name, a, b in zip("m l acc".split(), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_matches_reference_oracle(shape):
    args = _paged_inputs(*shape)
    _close(ref.paged_attention_ref(*_torch(args)),
           jref.paged_attention_ref(*_jax(args)))


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_matches_pallas_interpret(shape):
    args = _paged_inputs(*shape, seed=3)
    _close(ref.paged_attention_ref(*_torch(args)),
           pallas_paged(*_jax(args), interpret=True))


def test_dead_row_statistics():
    """A slot whose every table entry is dead returns m = -1e30, l = 0,
    acc = 0 (what a later span merge expects), not NaN."""
    args = list(_paged_inputs(*PAGED_SHAPES[0], seed=5))
    args[3][1, :] = args[1].shape[0]
    m, l, acc = ref.paged_attention_ref(*_torch(args))
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0)
    assert torch.all(acc[1] == 0)


def test_op_sends_cpu_tensors_to_plain_version():
    args = _torch(_paged_inputs(*PAGED_SHAPES[1], seed=7))
    before = paged_attention.launches
    for a, b in zip(ops.paged_attention_op(*args),
                    ref.paged_attention_ref(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert paged_attention.launches == before


def test_kernel_requested_on_cpu_raises():
    args = _torch(_paged_inputs(*PAGED_SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_op(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*args)


def test_scheduler_paged_kernels_true_on_cpu_raises():
    import dataclasses
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, device="cpu")
    serve = dataclasses.replace(cfg.serve, paged_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        SlotScheduler(cfg, params, serve=serve, device="cpu")
