"""serve.idle_share: 1 - busy / wall over the profiled stretch at the end
of the window, in %; busy is the union of the trace's device records."""


def read(obs):
    p = obs.get("profile")
    if obs.get("kind") != "serve" or p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
