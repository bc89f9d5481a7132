"""CP decomposition through the sketched contractions of ``repro_torch.core``:
symmetric RTPM (``rtpm``) and asymmetric ALS (``als``)."""
