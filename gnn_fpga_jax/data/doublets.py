"""Vectorised doublet (segment) selection and hit-graph construction.

One generic engine replaces the reference's two near-duplicate graph
builders (`/root/reference/gnn/graph.py:44-143` for ACTS/TrackML and
`/root/reference/gnn/Muon_graph.py:60-162` for the muon endcap): both are
"cross-join hits on a layer pair, cut on line-fit quantities, label edges
by a truth rule".  Here the cross-join is a numpy broadcast over
layer-sorted hit slices instead of a pandas merge — the reference's
preprocessing hot loop (minutes per mu200 file,
`GraphConstructionDev_mu200.ipynb:cell9`) becomes array ops.

Everything is host-side (numpy/pandas): this layer feeds preprocessing,
not the device (SURVEY.md §2.1 "acts.py" row).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from gnn_fpga_jax.core.graph import Graph, from_coo


def calc_dphi(phi1: np.ndarray, phi2: np.ndarray) -> np.ndarray:
    """phi2 - phi1 wrapped into [-pi, pi]  (`graph.py:37-42`)."""
    dphi = np.asarray(phi2) - np.asarray(phi1)
    dphi = np.where(dphi > np.pi, dphi - 2 * np.pi, dphi)
    dphi = np.where(dphi < -np.pi, dphi + 2 * np.pi, dphi)
    return dphi


def calc_eta(r: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Pseudorapidity from cylindrical coordinates."""
    theta = np.arctan2(r, z)
    return -np.log(np.tan(theta / 2.0))


@dataclasses.dataclass(frozen=True)
class SegmentCuts:
    """Geometric doublet-selection cuts.

    The reference applies a layer-dependent phi-slope threshold — inner
    layer pairs (first layer < ``inner_layer_max``) use ``phi_slope_max``,
    outer pairs use ``phi_slope_outer_max`` (`graph.py:65`; the committed
    code reads the pair's first row, i.e. the threshold is chosen per layer
    *pair*, which is what we implement).  ``phi_slope_mid_max`` is accepted
    for CLI parity but unused, exactly as in the reference.  Defaults are
    the muon builder's wide-open cuts (`Muon_graph.py:60`); the TrackML CLI
    defaults (slope 0.001 / z0 200, `prepareGraphs.py:37-40`) are set by the
    caller.
    """

    phi_slope_max: float = 1e31
    phi_slope_mid_max: float = 1e31
    phi_slope_outer_max: float = 1e31
    z0_max: float = 1e31
    inner_layer_max: int = 5

    def phi_slope_cut_for(self, layer1) -> float:
        return (self.phi_slope_max if layer1 < self.inner_layer_max
                else self.phi_slope_outer_max)


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    """Column names binding the generic engine to a dataset's DataFrame.

    TrackML/ACTS uses (evtid, layer, r, phi, z) + particle_id truth
    (`graph.py:53`, `prepareGraphs.py:75`); the muon endcap uses
    (entry, vh_layer, vh_sim_r, vh_sim_phi, vh_sim_z) + isMuon truth
    (`Muon_graph.py:72`, `:155-157`).
    """

    event: str = "evtid"
    layer: str = "layer"
    r: str = "r"
    phi: str = "phi"
    z: str = "z"
    label: str = "particle_id"   # per-hit truth id fed to label_rule


TRACKML_SCHEMA = ColumnSchema()
MUON_SCHEMA = ColumnSchema(event="entry", layer="vh_layer", r="vh_sim_r",
                           phi="vh_sim_phi", z="vh_sim_z", label="isMuon")


def same_particle_label(lbl1: np.ndarray, lbl2: np.ndarray) -> np.ndarray:
    """Edge truth: both endpoints from the same particle
    (`graph.py:137-139` ``y = (pid1 == pid2)``)."""
    return (lbl1 == lbl2).astype(np.float32)


def both_true_label(lbl1: np.ndarray, lbl2: np.ndarray) -> np.ndarray:
    """Edge truth: both endpoints truth-flagged (muon rule,
    `Muon_graph.py:155-157` ``y = isMuon_1 AND isMuon_2``)."""
    return ((lbl1 != 0) & (lbl2 != 0)).astype(np.float32)


def select_segments_arrays(
    r1, phi1, z1, r2, phi2, z2, phi_slope_cut: float, z0_max: float,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs doublet selection between two hit sets (vectorised).

    Computes the line through each hit pair: ``phi_slope = dphi/dr`` and
    ``z0 = z1 - r1*dz/dr`` (`graph.py:57-62`), cuts |phi_slope| and |z0|,
    and returns (i1, i2) local index pairs of surviving doublets.

    Uses the C++/OpenMP library (native/doublets.cpp) when built — no
    O(n1*n2) temporaries; numpy broadcasting otherwise.
    """
    if use_native:
        from gnn_fpga_jax.data import native
        out = native.select_segments_native(
            r1, phi1, z1, r2, phi2, z2, phi_slope_cut, z0_max)
        if out is not None:
            return out
    r1 = np.asarray(r1)[:, None]; phi1 = np.asarray(phi1)[:, None]
    z1 = np.asarray(z1)[:, None]
    r2 = np.asarray(r2)[None, :]; phi2 = np.asarray(phi2)[None, :]
    z2 = np.asarray(z2)[None, :]
    dphi = calc_dphi(phi1, phi2)
    dr = r2 - r1
    dz = z2 - z1
    with np.errstate(divide="ignore", invalid="ignore"):
        phi_slope = dphi / dr
        z0 = z1 - r1 * dz / dr
    good = (np.abs(phi_slope) < phi_slope_cut) & (np.abs(z0) < z0_max)
    return np.nonzero(good)


def construct_graph(
    hits: pd.DataFrame,
    layer_pairs: Sequence[Tuple[int, int]],
    cuts: SegmentCuts = SegmentCuts(),
    feature_names: Optional[Sequence[str]] = None,
    feature_scale: Optional[np.ndarray] = None,
    schema: ColumnSchema = TRACKML_SCHEMA,
    label_rule: Callable = same_particle_label,
    max_tracks: Optional[int] = None,
    no_missing_hits: bool = False,
    n_det_layers: int = 10,
    rng: Optional[np.random.Generator] = None,
    sort_by_layer: bool = False,
    return_layers: bool = False,
) -> Optional[Graph]:
    """Build one hit graph from one event's hits DataFrame.

    The vectorised counterpart of `graph.py:95-143` / `Muon_graph.py:117-162`:
    node features ``X = hits[feature_names] / feature_scale``, COO edge
    list from per-layer-pair doublet selection, labels from ``label_rule``.
    Returns None when no segments survive (the muon builder's empty-graph
    skip, `Muon_graph.py:133-138`).

    ``sort_by_layer`` orders nodes by detector layer — the invariant the
    blocked aggregation path needs (`ops/blocked.py`); ``return_layers``
    additionally returns the per-node layer array (saved into NPZ as the
    ``layer`` key so loaded graphs can ride the blocked path).  With
    ``return_layers`` the return value is ``(graph, layers)``
    (``(None, None)`` when no segments survive).
    """
    if feature_names is None:
        feature_names = [schema.r, schema.phi, schema.z]
    if feature_scale is None:
        feature_scale = np.ones(len(feature_names), np.float32)

    if no_missing_hits:  # perfect-track filter (`graph.py:102-104`)
        hits = hits.groupby(schema.label).filter(
            lambda t: t[schema.layer].nunique() == n_det_layers)
    if max_tracks is not None:  # track subsampling (`graph.py:105-109`)
        keys = hits[schema.label].drop_duplicates().values
        rng = rng or np.random.default_rng()
        rng.shuffle(keys)
        hits = hits[hits[schema.label].isin(keys[:max_tracks])]
    if sort_by_layer:
        # (layer, phi) order: layer-major for the blocked path's
        # block-diagonal invariant, phi within layer so a receiver's
        # senders (bounded to a narrow phi band by the phi-slope cut)
        # sit at nearby node ids
        hits = hits.sort_values([schema.layer, schema.phi], kind="stable")

    n_hits = len(hits)
    layer_vals = hits[schema.layer].to_numpy()
    r = hits[schema.r].to_numpy(np.float64)
    phi = hits[schema.phi].to_numpy(np.float64)
    z = hits[schema.z].to_numpy(np.float64)
    labels = hits[schema.label].to_numpy()

    # Positional indices per layer (replaces groupby.get_group + merge).
    layer_index: Dict[int, np.ndarray] = {}
    for lv in np.unique(layer_vals):
        layer_index[lv] = np.nonzero(layer_vals == lv)[0]

    senders_parts: List[np.ndarray] = []
    receivers_parts: List[np.ndarray] = []
    for (l1, l2) in layer_pairs:
        idx1 = layer_index.get(l1)
        idx2 = layer_index.get(l2)
        if idx1 is None or idx2 is None:  # empty-layer skip (`graph.py:85-89`)
            logging.debug("skipping empty layer pair (%s, %s)", l1, l2)
            continue
        i1, i2 = select_segments_arrays(
            r[idx1], phi[idx1], z[idx1], r[idx2], phi[idx2], z[idx2],
            cuts.phi_slope_cut_for(l1), cuts.z0_max)
        senders_parts.append(idx1[i1])
        receivers_parts.append(idx2[i2])

    if not senders_parts:
        logging.info("skipping event with no segments")
        return (None, None) if return_layers else None
    senders = np.concatenate(senders_parts)
    receivers = np.concatenate(receivers_parts)
    if len(senders) == 0:
        return (None, None) if return_layers else None

    x = (hits[list(feature_names)].to_numpy(np.float64)
         / np.asarray(feature_scale)).astype(np.float32)
    y = label_rule(labels[senders], labels[receivers])
    g = from_coo(x, senders, receivers, y)
    if return_layers:
        return g, layer_vals.astype(np.int32)
    return g


def segment_efficiency_purity(
    g: Graph, hits: pd.DataFrame, schema: ColumnSchema = TRACKML_SCHEMA,
    n_true_expected: Optional[int] = None,
) -> Dict[str, float]:
    """Graph-construction quality: purity = fraction of selected edges that
    are true; efficiency vs an expected true-edge count when given (the
    reference hard-codes 90, `prepareGraphs.py:127`)."""
    y = np.asarray(g.y)[np.asarray(g.edge_mask) > 0]
    out = {"n_edges": float(len(y)), "n_true": float(y.sum()),
           "purity": float(y.mean()) if len(y) else 0.0}
    if n_true_expected:
        out["efficiency"] = float(y.sum()) / n_true_expected
    return out


def adjacent_layer_pairs(n_det_layers: int) -> np.ndarray:
    """[(0,1), (1,2), ...] — `prepareGraphs.py:153-155`."""
    l = np.arange(n_det_layers)
    return np.stack([l[:-1], l[1:]], axis=1)


def dynamic_layer_pairs(layers_present: Sequence[float]) -> np.ndarray:
    """Per-event adjacent pairs of the *observed* layers, ± z-sides handled
    separately (muon pipeline, `prepareMuonGraphs.py:232-246`).  Both sides
    pair inner->outer: positive layers ascending, negative layers from the
    least-negative (closest to the IP) outward, matching the reference's
    ``stack([l_minus[1:], l_minus[:-1]])``."""
    l = np.unique(np.asarray(sorted(set(layers_present))))
    lp = l[l > 0]
    lm = l[l < 0]
    pairs = []
    if len(lp) > 1:
        pairs.append(np.stack([lp[:-1], lp[1:]], axis=1))
    if len(lm) > 1:
        pairs.append(np.stack([lm[1:], lm[:-1]], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype=l.dtype)
    return np.concatenate(pairs, axis=0)
