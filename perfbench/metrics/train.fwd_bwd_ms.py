"""train.fwd_bwd_ms: device ms of the train step's loss and gradients
(``make_train_step``'s call), CUDA events around each window step's
call, mean per step."""
import statistics


def read(obs):
    if obs.get("kind") != "train" or not obs["fwd_bwd_ms"]:
        return None
    return statistics.fmean(obs["fwd_bwd_ms"])
