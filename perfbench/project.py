"""Projections of a sketch table on seeded random directions.

A projection is first order in every entry of the table: a table whose
entries sit in other cells (a wrong hash or seed), or whose terms were
rounded coarser, moves it by about the norm of the difference, where a
norm of the table itself moves only to second order.  The program's and
the reference's tables are each projected alone, on the same directions
(standard normals drawn from the run's seed, the leaf and the table), and
the check compares the numbers.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.common import sub_seed

DIRECTIONS = 4
CHUNK = 1 << 24                  # entries drawn and summed at a time


def table_projections(table: torch.Tensor, seed: int, tag: str
                      ) -> Dict[str, object]:
    """{"proj": one float a direction, "norm": ||table||}."""
    flat = table.detach().reshape(-1)
    proj: List[float] = []
    for j in range(DIRECTIONS):
        g = torch.Generator(device=flat.device)
        g.manual_seed(sub_seed(seed, "direction", tag, j))
        total = torch.zeros((), dtype=torch.float64, device=flat.device)
        for s in range(0, flat.numel(), CHUNK):
            part = flat[s:s + CHUNK].float()
            r = torch.randn(part.numel(), generator=g, device=flat.device,
                            dtype=torch.float32)
            total += torch.dot(r, part).double()
        proj.append(float(total))
    norm = float(torch.linalg.vector_norm(flat.double()))
    return {"proj": proj, "norm": norm}


def leaf_moments(m: torch.Tensor, v: torch.Tensor, seed: int, leaf: str
                 ) -> Dict[str, Dict[str, object]]:
    """A sketched leaf's two tables, projected."""
    return {"m": table_projections(m, seed, leaf + ":m"),
            "v": table_projections(v, seed, leaf + ":v")}
