#!/usr/bin/env python3
"""Sketched RTPM at Fig. 1's setting in both packages, on the CPU.

Fig. 1 of the paper (``launch/cpd.py:FIG1``): a symmetric rank-10
tensor, I 100, unit weights, noise sigma 0.01, D 2 sketches, 15 inits,
20 power iterations.  For plain RTPM and TS / FCS at J 1000, 4000 and
10000, the reference (``repro.cpd.rtpm``) and the port
(``repro_torch.cpd.rtpm``) decompose the same tensor from the same
hashes (the reference's, carried over through numpy) and the same inits
(the ones the reference draws from its key).  Prints, for each run and
package, the clean residual ||T_clean - T_hat|| / ||T_clean||, the
observed residual against the noisy tensor, and the largest
|<u_true, u_hat>| over the recovered factors for the best-matched true
factor (the mean over the 10 true factors): 1 when a factor is found.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rtpm_d2.py [--J 1000,4000]
"""
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as rc
from repro.cpd import rtpm as ref_rtpm
from repro_torch.cpd import rtpm
from repro_torch.launch.cpd import FIG1
from repro_torch.models.bridge import mode_hashes_from_reference


def tensor(I, R, sigma, seed):
    """(noisy T, clean T, true factors (I, R)), as launch/cpd.py's
    ``symmetric_tensor`` builds them."""
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn((I, I), generator=gen))
    U = Q[:, :R]
    Tc = torch.einsum("ar,br,cr->abc", U, U, U)
    Tn = Tc + sigma * torch.randn(Tc.shape, generator=gen)
    return Tn.numpy(), Tc.numpy(), U.numpy()


def inits_of(key, R, L, I):
    """The raw inits the reference's ``rtpm`` draws for each component."""
    raw = []
    for _ in range(R):
        key, k1 = jax.random.split(key)
        raw.append(np.asarray(jax.random.normal(k1, (L, I))))
    return torch.from_numpy(np.stack(raw))


def scores(Tn, Tc, U, lams, V):
    lams = np.asarray(lams, np.float64)
    V = np.asarray(V, np.float64)
    est = np.einsum("r,ar,br,cr->abc", lams, V, V, V)
    clean = np.linalg.norm(Tc - est) / np.linalg.norm(Tc)
    observed = np.linalg.norm(Tn - est) / np.linalg.norm(Tn)
    Vn = V / np.maximum(np.linalg.norm(V, axis=0, keepdims=True), 1e-30)
    match = np.abs(U.T @ Vn).max(axis=1).mean()
    return clean, observed, match


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--J", default="1000,4000,10000")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    I, R, D, L, T = (FIG1[k] for k in ("I", "R", "D", "L", "T"))
    Tn, Tc, U = tensor(I, R, FIG1["sigma"], args.seed)
    key = jax.random.PRNGKey(5)
    inits = inits_of(key, R, L, I)
    runs = [("plain", 0)] + [(m, int(j)) for m in ("ts", "fcs")
                             for j in args.J.split(",")]
    for method, J in runs:
        t0 = time.perf_counter()
        rl, rU = ref_rtpm.rtpm_decompose(
            jnp.asarray(Tn), R, key, method=method, hash_len=max(J, 1),
            n_sketches=D, n_inits=L, n_iters=T)
        t1 = time.perf_counter()
        hashes = None
        if method != "plain":
            hashes = mode_hashes_from_reference(
                rc.make_tensor_hashes(key, Tn.shape, [J] * 3, D), "cpu")
        pl, pU = rtpm.rtpm_decompose(torch.from_numpy(Tn), R, method=method,
                                     n_inits=L, n_iters=T, hashes=hashes,
                                     inits=inits)
        t2 = time.perf_counter()
        for who, lams, V, secs in (("reference", rl, rU, t1 - t0),
                                   ("port", pl.numpy(), pU.numpy(),
                                    t2 - t1)):
            clean, observed, match = scores(Tn, Tc, U, lams, V)
            print(f"[rtpm] {method} J={J} (I={I}, R={R}, D={D}, L={L}, "
                  f"T={T}) {who}: clean residual {clean:.4f}, observed "
                  f"{observed:.4f}, mean best |<u, u_hat>| {match:.4f}; "
                  f"{secs:.1f}s on the CPU", flush=True)


if __name__ == "__main__":
    main()
