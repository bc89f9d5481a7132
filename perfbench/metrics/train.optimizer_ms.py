"""train.optimizer_ms: device ms of the optimizer's update (sketched
AdamW through ``sketch_update``), CUDA events around each window step's
update, mean per step."""
import statistics


def read(obs):
    if obs.get("kind") != "train" or not obs["optimizer_ms"]:
        return None
    return statistics.fmean(obs["optimizer_ms"])
