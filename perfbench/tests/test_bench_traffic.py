"""The generator repeats exactly for a seed and differs across seeds; a
serving mix's sizes are the same, in the same order, for every seed."""
import numpy as np
import torch

from perfbench import common, traffic

SEEDS = (1, 2 ** 31 + 12345)


def test_train_tokens_repeat_and_differ():
    mix = common.load_mix("train-4k-sketched")
    a = traffic.train_tokens(mix, 64000, SEEDS[1], 3, "cpu")
    assert a.shape == (1, 4097) and int(a.max()) < 64000
    assert torch.equal(a, traffic.train_tokens(mix, 64000, SEEDS[1], 3,
                                               "cpu"))
    assert not torch.equal(a, traffic.train_tokens(mix, 64000, SEEDS[0], 3,
                                                   "cpu"))
    assert not torch.equal(a, traffic.train_tokens(mix, 64000, SEEDS[1], 4,
                                                   "cpu"))


def test_serve_requests_repeat_and_differ():
    mix = common.load_mix("serve-chat")
    a = traffic.serve_requests(mix, 49155, SEEDS[0])
    b = traffic.serve_requests(mix, 49155, SEEDS[0])
    c = traffic.serve_requests(mix, 49155, SEEDS[1])
    assert len(a) == mix["requests"]
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               and x.temperature == y.temperature for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    key = lambda rs: [(len(r.prompt), r.max_new, r.temperature) for r in rs]
    assert key(a) == key(c)                     # the same work
    for r in a:
        assert 272 <= len(r.prompt) <= 3072 and r.shared_len == 256
        assert 4 <= r.max_new <= 1024
        assert len(r.prompt) + r.max_new <= mix["engine"]["max_seq"]
    sampled = sum(r.temperature > 0 for r in a)
    assert sampled == round(mix["sampled_share"] * len(a))


def test_serve_sizes_are_the_fitted_distribution():
    """The set of sizes is the mix's distributions at evenly spaced
    quantiles: the medians are the fitted ones."""
    mix = common.load_mix("serve-chat")
    sizes = traffic.serve_sizes(mix)
    prompts = sorted(s["prompt"] for s in sizes)
    news = sorted(s["max_new"] for s in sizes)
    n = len(sizes)
    assert prompts[n // 2 - 1] <= mix["prompt_tokens"]["median"] \
        <= prompts[n // 2]
    assert news[n // 2 - 1] <= mix["max_new"]["median"] <= news[n // 2]
    assert prompts == sorted(traffic.quantile_lengths(mix["prompt_tokens"],
                                                      n))
