"""Atomic checkpoints (port of ``repro/train/checkpoint.py``).

Format: one ``.npz`` of every state leaf, a JSON manifest (step, leaf
names, extra) and a ``LATEST`` pointer.  Each file is written to a temp
name and moved into place with ``os.replace`` (atomic on POSIX), and
``LATEST`` moves last, so a crash mid-write never corrupts the newest
complete checkpoint.  bf16 tensors are stored widened to f32 (exact) and
narrowed back on restore (bitwise).

A state is any nesting of dicts, lists and dataclasses whose
leaves are tensors or ints (a step counter); ``None`` and other values
are structure and are not stored.  ``restore`` loads into a state of the
same structure in place: tensors are overwritten with ``copy_`` (so they
keep their device) and ints are replaced, which makes a resumed run on
the CPU continue bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _walk(node: Any, path: str, visit: Callable[[str, Any, Callable], None],
          setter: Callable[[Any], None]) -> None:
    """Depth-first over the leaves, in a fixed order; ``visit(name, leaf,
    set)`` gets a setter that replaces the leaf in its container."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(node, torch.Tensor) or (isinstance(node, int)
                                          and not isinstance(node, bool)):
        visit(path, node, setter)
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], join(k), visit,
                  lambda v, k=k: node.__setitem__(k, v))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk(v, join(i), visit, lambda x, i=i: node.__setitem__(i, x))
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), join(f.name), visit,
                  lambda v, f=f: setattr(node, f.name, v))


def _leaves(state: Any) -> List[Tuple[str, Any, Callable]]:
    out: List[Tuple[str, Any, Callable]] = []
    _walk(state, "", lambda n, v, s: out.append((n, v, s)), lambda v: None)
    return out


def _encode(v: Any) -> np.ndarray:
    if isinstance(v, int):
        return np.asarray(v, dtype=np.int64)
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def save(path: str, step: int, state: Any, extra: Optional[dict] = None
         ) -> None:
    leaves = _leaves(state)
    os.makedirs(path, exist_ok=True)
    tmp_npz = os.path.join(path, f".tmp.{step}.npz")
    np.savez(tmp_npz, **{f"a{i}": _encode(v)
                         for i, (_, v, _) in enumerate(leaves)})
    manifest = {"step": int(step), "names": [n for n, _, _ in leaves],
                "extra": extra or {}}
    tmp_json = os.path.join(path, f".tmp.{step}.json")
    with open(tmp_json, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_npz, os.path.join(path, f"ckpt_{step:08d}.npz"))
    os.replace(tmp_json, os.path.join(path, f"ckpt_{step:08d}.json"))
    tmp_l = os.path.join(path, ".tmp.latest")
    with open(tmp_l, "w") as f:
        f.write(str(step))
    os.replace(tmp_l, os.path.join(path, "LATEST"))


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(path: str, state_like: Any,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """Load checkpoint ``step`` (default: LATEST) into ``state_like`` in
    place; returns (step, state_like)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, f"ckpt_{step:08d}.json")) as f:
        names = json.load(f)["names"]
    leaves = _leaves(state_like)
    if names != [n for n, _, _ in leaves]:
        raise ValueError(f"checkpoint {step} under {path} holds another "
                         f"state structure")
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as data:
        for i, (_, v, set_) in enumerate(leaves):
            a = data[f"a{i}"]
            if isinstance(v, int):
                set_(int(a))
            else:
                v.copy_(torch.from_numpy(a).to(v.dtype))
    return step, state_like
