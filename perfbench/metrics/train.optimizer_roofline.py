"""train.optimizer_roofline: the least time of the update's bytes at the
card's bandwidth (``roofline.sketched_adamw_bytes``: each sketched leaf's
gradient read, its tables read and written, its params read and written
once; the dense leaves' AdamW bytes), over ``train.optimizer_ms``, in
%."""
import statistics

from perfbench import roofline


def read(obs):
    if obs.get("kind") != "train" or not obs["optimizer_ms"]:
        return None
    least = roofline.least_ms(roofline.sketched_adamw_bytes(
        obs["conf"], obs["mix"]["optimizer"]))
    return 100.0 * least / statistics.fmean(obs["optimizer_ms"])
