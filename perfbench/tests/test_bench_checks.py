"""The comparison that decides ``correct`` fails when it should: a run
with the timed path broken underneath, and the control (the reference in
float8 in the program's place), each come out not correct.  On the CPU
at small sizes, with the small size's limits (``tiny.LIMITS``)."""
import pytest
import tiny

from perfbench import checks, common
from perfbench.common import sub_seed
from perfbench.reference import train as ref_train


def test_sound_runs_are_correct():
    assert tiny.run(tiny.train_cell())["correct"]
    assert tiny.run(tiny.serve_cell())["correct"]


def test_train_step_that_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.sketch import optimizer as sko
    monkeypatch.setattr(sko, "sketched_adamw_update",
                        lambda grads, state, params, **kw: (params, state))
    line = tiny.run(tiny.train_cell())
    assert not line["correct"]
    assert line["checks"]["delta_gap"]["value"] > 0.5


def test_train_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.models import layers as ly
    full = ly.cross_entropy

    def half(params, x, labels, cfg, *a, **kw):
        S = x.shape[1] // 2
        return full(params, x[:, :S], labels[:, :S], cfg, *a, **kw)
    monkeypatch.setattr(ly, "cross_entropy", half)
    assert not tiny.run(tiny.train_cell())["correct"]


def test_train_wrong_hash_seed(monkeypatch):
    """Every sketched table hashed with the next table's seed: the
    gradient norms hold, the tables' projections do not."""
    from repro_torch.sketch import optimizer as sko
    leaf_seed = sko._leaf_seed
    monkeypatch.setattr(sko, "_leaf_seed",
                        lambda seed, i: leaf_seed(seed, i + 1))
    line = tiny.run(tiny.train_cell())
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] <= \
        line["checks"]["grad_gap"]["limit"]
    assert line["checks"]["moment_gap"]["value"] > 1.0


def test_serve_one_slot_corrupted(monkeypatch):
    """Slot 0 alone decodes from negated logits while the other slots
    serve correctly: the requests it served are among the checked ones,
    and their tokens rank far below the reference's best."""
    from repro_torch.models import transformer as tf
    step = tf.decode_step

    def one_slot(*a, **kw):
        logits, cache = step(*a, **kw)
        logits = logits.clone()
        logits[0] = -logits[0]
        return logits, cache
    monkeypatch.setattr(tf, "decode_step", one_slot)
    line = tiny.run(tiny.serve_cell())
    assert not line["correct"]
    assert line["checks"]["worst_token_rank"]["value"] > \
        line["checks"]["worst_token_rank"]["limit"]
    assert line["checks"]["request_logit_gap"]["value"] <= \
        line["checks"]["request_logit_gap"]["limit"]


def test_serve_token_altered_where_it_is_produced(monkeypatch):
    """Every slot decodes from negated logits, in the greedy and the
    sampled chunk alike (a live sampled request runs every slot through
    the sampler)."""
    from repro_torch.models import transformer as tf
    step = tf.decode_step

    def negated(*a, **kw):
        logits, cache = step(*a, **kw)
        return -logits, cache
    monkeypatch.setattr(tf, "decode_step", negated)
    line = tiny.run(tiny.serve_cell())
    assert not line["correct"]


def test_train_control_is_not_correct():
    name, conf, mix = tiny.train_cell()
    seed = 31337
    hs = sub_seed(seed, "hash") % (1 << 31)
    n = mix["check"]["steps"]
    ref = ref_train.run(conf, mix, seed, hs, "cpu", n)
    ctrl = ref_train.run(conf, mix, seed, hs, "cpu", n, precision="fp8")
    found = checks.train_numbers(ctrl, ref)
    limits = tiny.LIMITS[name]
    assert any(v > limits[k] for k, v in found.items()), found


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 9])
def test_serve_control_is_not_correct(seed):
    line = tiny.run(tiny.serve_cell(), seed=seed, readings=True)
    limits = tiny.LIMITS["granite-moe-3b.serve-chat"]
    assert line["notes"]["control_request_gap"] > limits["request_logit_gap"]
    assert line["notes"]["altered_worst_rank"] > limits["worst_token_rank"]


def test_cells_limits_lie_between_their_readings():
    for name in ("yi-9b.train-4k-sketched", "granite-moe-3b.serve-chat"):
        got = common.load_limits(name)
        assert set(got) == set(tiny.LIMITS[name])
