"""train.moment_gib: the optimizer's moment state in GiB
(``sketch/optimizer.moment_state_bytes(state)["total"]``)."""


def read(obs):
    if obs.get("kind") != "train":
        return None
    return obs["moment_bytes"] / 2 ** 30
