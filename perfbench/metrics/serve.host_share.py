"""serve.host_share: share of the window's wall the host spends launching
work, in %: the pump's ``dispatch`` spans and the prefill chunks' launch
spans of a ``repro_torch.obs.ServeObserver`` (traced runs only).  The
pump's ``collect`` span is left out: it is mostly the wait for the card."""


def read(obs):
    if obs.get("kind") != "serve" or obs.get("host_span_s") is None:
        return None
    return 100.0 * obs["host_span_s"] / obs["window_s"]
