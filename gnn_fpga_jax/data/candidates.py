"""Fixed-size candidate graphs for seeded hit classification.

Re-implements the data pipeline of
`/root/reference/gnn/MPNN_HitClassifier.ipynb:cell8-15`: for each true
(signal) track, select the ``n_layer_hits`` hits nearest in (eta, phi) to
the track's hit on every detector layer, centre phi on the first true hit,
attach a seed feature marking the track's hits on the first
``n_seed_layers`` layers, and connect all adjacent-layer candidate pairs.
Every candidate graph has exactly ``n_det_layers * n_layer_hits`` nodes
and a fixed edge count — naturally static shapes, ideal for XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from gnn_fpga_jax.core.graph import Graph
from gnn_fpga_jax.data.doublets import calc_dphi, calc_eta


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    n_det_layers: int = 10
    n_layer_hits: int = 5      # candidates per layer (`cell8`)
    n_seed_layers: int = 3     # layers whose truth seeds the input
    feature_names: Tuple[str, ...] = ("r", "phi", "z")
    feature_scale: Optional[np.ndarray] = None   # default [1000, pi, 1000]
    event_key: str = "evtid"
    label_key: str = "barcode"

    def scale(self) -> np.ndarray:
        if self.feature_scale is not None:
            return np.asarray(self.feature_scale, np.float64)
        return np.array([1000.0, np.pi, 1000.0])


def eta_phi_distance(eta1, eta2, phi1, phi2) -> np.ndarray:
    """ΔR = sqrt(Δeta² + Δphi²) (`cell7` calc_eta_phi_distance)."""
    deta = np.asarray(eta2) - np.asarray(eta1)
    dphi = calc_dphi(np.asarray(phi1), np.asarray(phi2))
    return np.sqrt(deta ** 2 + dphi ** 2)


def candidate_edges(n_det_layers: int, n_layer_hits: int):
    """Adjacent-layer all-pairs edges over the fixed candidate layout
    (nodes ordered layer-major)."""
    idx = np.arange(n_det_layers * n_layer_hits).reshape(
        n_det_layers, n_layer_hits)
    senders, receivers = [], []
    for k in range(n_det_layers - 1):
        s, r = np.meshgrid(idx[k], idx[k + 1], indexing="ij")
        senders.append(s.ravel())
        receivers.append(r.ravel())
    return (np.concatenate(senders).astype(np.int32),
            np.concatenate(receivers).astype(np.int32))


def build_candidate_graph(evt_hits: pd.DataFrame, pid,
                          cfg: CandidateConfig = CandidateConfig()
                          ) -> Optional[Graph]:
    """One (event, signal track) -> fixed-size candidate Graph
    (`cell13`).  Returns None when the track doesn't hit every layer
    exactly once (the notebook asserts; we skip)."""
    trk_hits = evt_hits[evt_hits[cfg.label_key] == pid]
    if (len(trk_hits) != cfg.n_det_layers
            or not np.array_equal(np.sort(trk_hits["layer"].to_numpy()),
                                  np.arange(cfg.n_det_layers))):
        return None
    trk_hits = trk_hits.sort_values("layer")

    cand_parts = []
    for j in range(cfg.n_det_layers):
        lay_hits = evt_hits[evt_hits["layer"] == j]
        if len(lay_hits) < cfg.n_layer_hits:
            return None
        trk_hit = trk_hits.iloc[j]
        trk_eta = calc_eta(trk_hit["r"], trk_hit["z"])
        lay_eta = calc_eta(lay_hits["r"].to_numpy(), lay_hits["z"].to_numpy())
        d = eta_phi_distance(trk_eta, lay_eta, trk_hit["phi"],
                             lay_hits["phi"].to_numpy())
        nearest = np.argsort(d, kind="stable")[: cfg.n_layer_hits]
        cand_parts.append(lay_hits.iloc[nearest])
    cand_hits = pd.concat(cand_parts)

    # Centre phi on the first true hit (`cell13`).
    phi0 = trk_hits["phi"].iloc[0]
    cand_hits = cand_hits.assign(
        phi=calc_dphi(np.full(len(cand_hits), phi0),
                      cand_hits["phi"].to_numpy()))

    node_y = (cand_hits[cfg.label_key] == pid).to_numpy(np.float32)
    feats = (cand_hits[list(cfg.feature_names)].to_numpy(np.float64)
             / cfg.scale()).astype(np.float32)
    layers = cand_hits["layer"].to_numpy()
    seed = np.where(layers < cfg.n_seed_layers, node_y, 0.0)
    x = np.concatenate([feats, seed[:, None].astype(np.float32)], axis=1)

    senders, receivers = candidate_edges(cfg.n_det_layers, cfg.n_layer_hits)
    n_node = cfg.n_det_layers * cfg.n_layer_hits
    ey = (node_y[senders] * node_y[receivers]).astype(np.float32)
    return Graph(
        x=x,
        senders=senders,
        receivers=receivers,
        y=ey,
        node_mask=np.ones(n_node, np.float32),
        edge_mask=np.ones(len(senders), np.float32),
        node_y=node_y,
    )


def build_candidate_dataset(hits: pd.DataFrame,
                            cfg: CandidateConfig = CandidateConfig(),
                            max_samples: Optional[int] = None) -> List[Graph]:
    """All (event, track) pairs -> list of candidate graphs (`cell13`)."""
    out = []
    for (eid, pid), _ in hits.groupby([cfg.event_key, cfg.label_key]):
        evt_hits = hits[hits[cfg.event_key] == eid]
        g = build_candidate_graph(evt_hits, pid, cfg)
        if g is not None:
            out.append(g)
            if max_samples is not None and len(out) >= max_samples:
                break
    return out
