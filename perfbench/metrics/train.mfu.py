"""train.mfu: model FLOPs of a step (6 N T plus causal attention,
``roofline.train_step_flops``) over the mean wall time of the window's
unprofiled steps times the card's bf16 peak, in %."""
import statistics

from perfbench import roofline


def read(obs):
    if obs.get("kind") != "train" or not obs.get("step_s"):
        return None
    mix = obs["mix"]
    flops = roofline.train_step_flops(obs["conf"], mix["batch"], mix["seq"])
    return 100.0 * flops / (statistics.fmean(obs["step_s"])
                            * roofline.BF16_FLOPS)
