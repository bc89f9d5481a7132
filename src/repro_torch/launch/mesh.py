"""Production mesh construction (``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches
no device or process-group state.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh``) over
the process group the caller has already initialised, one rank per
device:

- ``"cuda"`` (default): one card a rank, NCCL;
- ``"cpu"``: gloo ranks on the CPU (the tests' small meshes);
- ``"meta"``: the dry run's planning mesh over PyTorch's fake process
  group (launch/dryrun.py).  A mesh needs a real backend type, so it is
  a ``"cpu"`` mesh; the dry run's tensors live on the meta device.
"""
from __future__ import annotations

from typing import Sequence


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """Elastic variant: any (data, model) / (pod, data, model) shape over
    the initialised process group, whose world size must equal the
    product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device_type {device_type!r}: cuda, cpu or meta")
    if device_type == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a card; pass "
                               "device_type='cpu' for gloo ranks")
    kind = "cpu" if device_type == "meta" else device_type
    return init_device_mesh(kind, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """((shape), (axes)) of the production mesh: 16 x 16 (data, model),
    or 2 x 16 x 16 (pod, data, model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)
