"""Dataset characterization utilities (the ActsExplore1 workload).

Vectorized equivalents of the reference's exploration notebook
(`/root/reference/gnn/ActsExplore1.ipynb:cell14,17-20`): per-track
angular spans, hit/track multiplicities, and signal-vs-background
hit-to-particle Δφ/Δη/ΔR distributions — the quantities that motivate the
doublet selection cuts (`GraphConstructionDev.ipynb`).

The reference computes these with pandas ``groupby().apply`` (a Python
loop per particle); here everything is lexsort + segment reductions over
flat numpy arrays, so a full mu200 file characterizes in milliseconds.
All functions take the processed hits/particles DataFrames produced by
:mod:`gnn_fpga_jax.data.acts` (columns ``evtid, barcode, r, phi, z, eta``
for hits; ``evtid, barcode, pt, eta, phi`` for particles).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from gnn_fpga_jax.data.doublets import calc_dphi, calc_eta


def calc_dr(eta1, eta2, phi1, phi2) -> np.ndarray:
    """ΔR = sqrt(Δη² + Δφ²) with φ wrapped to [-π, π]
    (`ActsExplore1.ipynb:cell17` calc_dR)."""
    deta = np.abs(np.asarray(eta1) - np.asarray(eta2))
    dphi = np.abs(calc_dphi(np.asarray(phi1), np.asarray(phi2)))
    return np.sqrt(deta * deta + dphi * dphi)


def _group_index(evtid: np.ndarray, barcode: np.ndarray,
                 order_key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort rows by (evtid, barcode, order_key); return (order, group_id)
    with group_id contiguous per (evtid, barcode)."""
    order = np.lexsort((np.asarray(order_key), np.asarray(barcode),
                        np.asarray(evtid)))
    ev, bc = np.asarray(evtid)[order], np.asarray(barcode)[order]
    new = np.concatenate([[True], (ev[1:] != ev[:-1]) | (bc[1:] != bc[:-1])])
    return order, np.cumsum(new) - 1


def track_spans(hits) -> Dict[str, np.ndarray]:
    """Per-(event, particle) hit count, |Δφ| first↔last hit (sorted by r),
    and Δη span — `ActsExplore1.ipynb:cell14` (df_calc_dphi / nhits / deta),
    vectorized (one lexsort instead of a groupby-apply per particle).

    Returns arrays aligned per track: ``{"nhits", "dphi", "deta"}``.
    """
    order, gid = _group_index(hits["evtid"].values, hits["barcode"].values,
                              hits["r"].values)
    phi = hits["phi"].values[order]
    eta = (hits["eta"].values[order] if "eta" in hits
           else calc_eta(hits["r"].values, hits["z"].values)[order])
    n_groups = gid[-1] + 1 if len(gid) else 0
    first = np.concatenate([[0], np.flatnonzero(np.diff(gid)) + 1])
    last = np.concatenate([np.flatnonzero(np.diff(gid)), [len(gid) - 1]])
    nhits = np.bincount(gid, minlength=n_groups)
    dphi = np.abs(calc_dphi(phi[last], phi[first]))
    eta_max = np.maximum.reduceat(eta, first)
    eta_min = np.minimum.reduceat(eta, first)
    return {"nhits": nhits, "dphi": dphi, "deta": eta_max - eta_min}


def multiplicities(hits, particles) -> Dict[str, np.ndarray]:
    """Per-event track and hit multiplicities
    (`ActsExplore1.ipynb:cell20`)."""
    def per_event(df):
        ev = np.asarray(df["evtid"].values)
        ids = np.unique(ev)
        return np.bincount(np.searchsorted(ids, ev), minlength=len(ids))

    return {"tracks_per_event": per_event(particles),
            "hits_per_event": per_event(hits)}


def hit_particle_deltas(hits, particles) -> Dict[str, Dict[str, np.ndarray]]:
    """Signal vs background hit↔particle Δφ/Δη/ΔR distributions
    (`ActsExplore1.ipynb:cell18`): every (hit, particle) pair within an
    event, split by whether the hit belongs to that particle.

    Returns ``{"signal": {...}, "background": {...}}`` each holding
    ``dphi``, ``deta``, ``dr`` arrays.  The quantities bound the graph
    construction windows (how far a true track's hits stray from its
    generated direction vs how close random hits come).
    """
    import pandas as pd

    hp = hits.merge(particles, on="evtid", how="inner",
                    suffixes=("_hit", "_par"))
    sig = hp["barcode_hit"].values == hp["barcode_par"].values
    out = {}
    for name, m in (("signal", sig), ("background", ~sig)):
        dphi = np.abs(calc_dphi(hp["phi_hit"].values[m],
                                hp["phi_par"].values[m]))
        deta = np.abs(hp["eta_hit"].values[m] - hp["eta_par"].values[m])
        out[name] = {"dphi": dphi, "deta": deta,
                     "dr": np.sqrt(deta * deta + dphi * dphi)}
    return out


def layer_occupancy(hits) -> Dict[Tuple[int, int], int]:
    """Hit counts per (volume, layer) — the per-layer hit-map summary of
    `ActsExplore1.ipynb:cell18` (z-φ maps) reduced to occupancies."""
    vol = hits["volid"].values if "volid" in hits else np.zeros(len(hits), int)
    lay = hits["layer"].values if "layer" in hits else hits["layid"].values
    keys, counts = np.unique(np.stack([vol, lay]), axis=1, return_counts=True)
    return {(int(v), int(l)): int(c)
            for (v, l), c in zip(keys.T, counts)}
