"""Full-event graph construction via adjacency-window cuts.

Re-implements the in-notebook constructor of
`/root/reference/gnn/MPNN_Seg_ACTS_fullEvents.ipynb:cell6,11-12`: instead of
per-layer-pair line-fit cuts, edges are all adjacent-layer hit pairs within
a (|dphi| < dphi_max, |dz| < dz_max) window, with event-level occupancy
filters (50 < nodes < 500, edges < 1000 in the notebook) to bound graph
sizes.  COO output — the dense Ri/Ro of the notebook never materialise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from gnn_fpga_jax.core.graph import Graph, from_coo
from gnn_fpga_jax.data.doublets import calc_dphi


@dataclasses.dataclass(frozen=True)
class FullEventConfig:
    dphi_max: float = np.pi / 4
    dz_max: float = 300.0
    feature_names: Sequence[str] = ("r", "phi", "z")
    feature_scale: Optional[np.ndarray] = None  # default [1000, pi, 1000]
    # Occupancy filters (`cell11`): None disables
    n_nodes_min: Optional[int] = 50
    n_nodes_max: Optional[int] = 500
    n_edges_max: Optional[int] = 1000
    layer_key: str = "layer"
    label_key: str = "barcode"

    def scale(self) -> np.ndarray:
        if self.feature_scale is not None:
            return np.asarray(self.feature_scale, np.float64)
        return np.array([1000.0, np.pi, 1000.0])


def construct_graph(hits: pd.DataFrame,
                    cfg: FullEventConfig = FullEventConfig()) -> Graph:
    """One event -> COO graph with adjacency-window edges (`cell6`)."""
    layers = hits[cfg.layer_key].to_numpy()
    phi = hits["phi"].to_numpy(np.float64)
    z = hits["z"].to_numpy(np.float64)
    pid = hits[cfg.label_key].to_numpy()

    adj = ((layers[None, :] - layers[:, None]) == 1)
    adj &= np.abs(calc_dphi(phi[:, None], phi[None, :])) < cfg.dphi_max
    adj &= np.abs(z[None, :] - z[:, None]) < cfg.dz_max
    senders, receivers = np.nonzero(adj)

    x = (hits[list(cfg.feature_names)].to_numpy(np.float64)
         / cfg.scale()).astype(np.float32)
    y = (pid[senders] == pid[receivers]).astype(np.float32)
    return from_coo(x, senders, receivers, y)


def passes_occupancy(g: Graph, cfg: FullEventConfig) -> bool:
    """Event-level occupancy filter (`cell11-12`)."""
    n, e = g.n_node, g.n_edge
    if cfg.n_nodes_min is not None and n <= cfg.n_nodes_min:
        return False
    if cfg.n_nodes_max is not None and n >= cfg.n_nodes_max:
        return False
    if cfg.n_edges_max is not None and e >= cfg.n_edges_max:
        return False
    return True


def build_event_graphs(hits: pd.DataFrame, event_key: str = "evtid",
                       cfg: FullEventConfig = FullEventConfig()) -> List[Graph]:
    """All events -> occupancy-filtered graph list (`cell12`)."""
    out = []
    for _, evt_hits in hits.groupby(event_key):
        g = construct_graph(evt_hits, cfg)
        if passes_occupancy(g, cfg):
            out.append(g)
    return out
