"""The benchmark's own arithmetic."""
import pytest

from perfbench import common, roofline, weights


def test_yi9b_sketched_adamw_bound():
    conf = common.load_json(common.HERE / "configs" / "yi-9b.json")
    opt = common.load_mix("train-4k-sketched")["optimizer"]
    sketched = [lf for lf in weights.leaves(conf)
                if lf.numel >= opt["opt_state_min_elems"]]
    assert len(sketched) == 11
    assert sum(lf.numel for lf in sketched) == 8_829_403_136
    ms = roofline.least_ms(roofline.sketched_adamw_bytes(conf, opt))
    assert round(ms, 3) == 26.356


def test_peaks_and_flops():
    assert roofline.BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    conf = common.load_json(common.HERE / "configs" / "yi-9b.json")
    n = roofline.matmul_params(conf, active=True)
    assert n == pytest.approx(8.56e9, rel=0.01)
    moe = common.load_json(common.HERE / "configs" /
                           "granite-moe-3b-a800m.json")
    active = roofline.matmul_params(moe, active=True)
    total = roofline.matmul_params(moe, active=False)
    assert active < total / 3
    assert roofline.kv_row_bytes(moe) == 2 * 8 * 64 * 2 * 32
