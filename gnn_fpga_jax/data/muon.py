"""Muon-endcap (EMTF) graph-building pipeline.

Re-implements `/root/reference/gnn/prepareMuonGraphs.py`: pair single-muon
signal ntuples with PU200 pileup ntuples, map (type, station, ring) to an
EMTF layer number, truth-match, deduplicate per station, mix signal+PU
hits per event, build per-event dynamic layer pairs split by z-sign, and
construct edge-labelled graphs carrying the generated muon's (pt, eta).

ROOT input goes through ``uproot`` when available; otherwise any source
that yields the same flat hit table (parquet / CSV / in-memory DataFrame)
works — the pipeline itself is DataFrame-in, Graph-out.

The row-wise ``DataFrame.apply`` layer lookup (`prepareMuonGraphs.py:175-176`)
is replaced with one vectorised LUT indexing operation.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from gnn_fpga_jax.core.graph import Graph, save_npz
from gnn_fpga_jax.data import doublets

try:  # pragma: no cover - environment-dependent
    import uproot as _uproot
except ImportError:
    _uproot = None

# Subsystem enums (`prepareMuonGraphs.py:160`).
K_DT, K_CSC, K_RPC, K_GEM, K_ME0 = 0, 1, 2, 3, 4

HIT_FEATURES = ["vh_sim_z", "vh_sim_theta", "vh_sim_phi", "vh_sim_r",
                "vh_bend", "vh_sim_tp1", "vh_sim_tp2", "vh_station",
                "vh_ring", "vh_type"]


def make_emtf_lut() -> np.ndarray:
    """(type, station, ring) -> EMTF layer 1..12, -99 = unmapped
    (`prepareMuonGraphs.py:50-92`, the active assignments)."""
    lut = np.full((5, 5, 5), -99, dtype=np.int32)
    assignments = {
        # CSC (type 1)
        (1, 1, 4): 3,  (1, 1, 1): 3,   # ME1/1a, ME1/1b
        (1, 1, 2): 4,  (1, 1, 3): 4,   # ME1/2, ME1/3
        (1, 2, 1): 8,  (1, 2, 2): 8,   # ME2/1, ME2/2
        (1, 3, 1): 9,  (1, 3, 2): 9,   # ME3/1, ME3/2
        (1, 4, 1): 11, (1, 4, 2): 11,  # ME4/1, ME4/2
        # RPC (type 2)
        (2, 1, 2): 5,                  # RE1/2
        (2, 2, 2): 6,                  # RE2/2
        (2, 3, 1): 10, (2, 3, 2): 10, (2, 3, 3): 10,  # RE3/*
        (2, 4, 1): 12, (2, 4, 2): 12, (2, 4, 3): 12,  # RE4/*
        # GEM (type 3) + ME0 (type 4)
        (3, 1, 1): 2, (3, 2, 1): 7, (4, 1, 1): 1,
    }
    for (t, s, r), layer in assignments.items():
        lut[t, s, r] = layer
    return lut


EMTF_LUT = make_emtf_lut()


def get_layer(hit_type, station, ring) -> int:
    """Scalar LUT lookup (`prepareMuonGraphs.py:96-97`)."""
    return int(EMTF_LUT[int(hit_type), int(station), int(ring)])


def assign_layers(df: pd.DataFrame) -> pd.DataFrame:
    """Vectorised ``vh_layer`` assignment from (vh_type, vh_station,
    vh_ring), dropping unmapped hits (layer == -99)."""
    layer = EMTF_LUT[df["vh_type"].to_numpy(np.int64),
                     df["vh_station"].to_numpy(np.int64),
                     df["vh_ring"].to_numpy(np.int64)]
    df = df.assign(vh_layer=layer)
    return df[df["vh_layer"] > -99]


def load_ntuple(path: str, entry_start: int = 0, entry_stop: int = 100,
                branches: Sequence[str] = tuple(HIT_FEATURES),
                extra_branches: Sequence[str] = ()) -> pd.DataFrame:
    """Read a flat hit table from a ROOT ntuple (``ntupler/tree``,
    `prepareMuonGraphs.py:153-173`) or from parquet/CSV with the same
    columns plus an ``entry`` event-index column."""
    if path.endswith(".root"):
        if _uproot is None:
            raise ImportError(
                "uproot is not installed; convert the ntuple to parquet/CSV "
                "with columns %s + 'entry'" % list(branches))
        tree = _uproot.open(path)["ntupler"]["tree"]
        df = tree.arrays(list(branches) + list(extra_branches),
                         entry_start=entry_start, entry_stop=entry_stop,
                         library="pd")
        if "entry" not in df.columns:
            df = df.reset_index().rename(columns={"index": "entry",
                                                  "level_0": "entry"})
        return df
    if path.endswith(".parquet"):
        df = pd.read_parquet(path)
    else:
        df = pd.read_csv(path)
    return df[(df["entry"] >= entry_start) & (df["entry"] < entry_stop)]


@dataclasses.dataclass(frozen=True)
class MuonPipelineConfig:
    muon_only: bool = False
    entry_start: int = 0
    entry_stop: int = 100
    feature_names: Tuple[str, ...] = tuple(HIT_FEATURES) + ("vh_layer",)
    # All-ones feature scale, as committed (`prepareMuonGraphs.py:228`).
    feature_scale: Optional[np.ndarray] = None


def prepare_hits(df_muon: pd.DataFrame, df_pu: pd.DataFrame,
                 cfg: MuonPipelineConfig = MuonPipelineConfig()):
    """Signal/PU preparation + per-event mixing
    (`prepareMuonGraphs.py:175-215`):

    - EMTF layer assignment, unmapped hits dropped;
    - ``isMuon`` flag 1/0 for signal/PU;
    - layer sign-split by z (`:189-190`): vh_layer *= sign(vh_sim_z);
    - truth matching on the signal: vh_sim_tp1 == 0 & vh_sim_tp2 == 0;
    - per-station dedup within each event (drop_duplicates on
      (type, station, ring), `:202,209`);
    - per-event signal+PU concat (events matched by position in the PU
      event list, `:208-215`).

    Returns (mixed_events, muon_events): dicts entry -> DataFrame.
    """
    df_muon = assign_layers(df_muon).assign(isMuon=1.0)
    df_pu = assign_layers(df_pu).assign(isMuon=0.0)
    for df in (df_muon, df_pu):
        df["vh_layer"] = df["vh_layer"] * np.sign(df["vh_sim_z"])
    df_muon = df_muon[(df_muon["vh_sim_tp1"] == 0)
                      & (df_muon["vh_sim_tp2"] == 0)]

    muon_events: Dict[int, pd.DataFrame] = {}
    for entry, g in df_muon.groupby("entry"):
        muon_events[int(entry)] = g.drop_duplicates(
            ["vh_type", "vh_station", "vh_ring"])

    mixed_events: Dict[int, pd.DataFrame] = {}
    muon_entries = sorted(muon_events)
    for i, (entry_pu, g_pu) in enumerate(df_pu.groupby("entry")):
        if i >= len(muon_entries):
            break
        g_pu = g_pu.drop_duplicates(["vh_type", "vh_station", "vh_ring"])
        mixed_events[int(entry_pu)] = pd.concat(
            [g_pu, muon_events[muon_entries[i]]], ignore_index=True)
    return mixed_events, muon_events


def build_event_graph(event_hits: pd.DataFrame,
                      cfg: MuonPipelineConfig = MuonPipelineConfig()) -> Optional[Graph]:
    """One event -> Graph: dynamic ± z layer pairs from the observed layers
    (`prepareMuonGraphs.py:232-246`), open cuts, isMuon-AND edge labels
    (`Muon_graph.py:155-157`)."""
    pairs = doublets.dynamic_layer_pairs(event_hits["vh_layer"].tolist())
    if len(pairs) == 0:
        return None
    feature_scale = (cfg.feature_scale if cfg.feature_scale is not None
                     else np.ones(len(cfg.feature_names), np.float32))
    hits = event_hits.reset_index(drop=True)
    return doublets.construct_graph(
        hits, pairs, cuts=doublets.SegmentCuts(),
        feature_names=list(cfg.feature_names), feature_scale=feature_scale,
        schema=doublets.MUON_SCHEMA, label_rule=doublets.both_true_label)


def build_graphs(df_muon: pd.DataFrame, df_pu: pd.DataFrame,
                 gen_properties: Optional[pd.DataFrame] = None,
                 cfg: MuonPipelineConfig = MuonPipelineConfig()):
    """Full pipeline: returns list of (entry, Graph, extras) where extras
    holds the generated muon's pt/eta when ``gen_properties``
    (columns vp_pt, vp_eta indexed by entry) is given
    (`prepareMuonGraphs.py:230-263`)."""
    mixed, muon_only = prepare_hits(df_muon, df_pu, cfg)
    events = muon_only if cfg.muon_only else mixed
    out = []
    for entry in sorted(events):
        g = build_event_graph(events[entry], cfg)
        if g is None:
            logging.info("entry %d: empty graph skipped", entry)
            continue
        extras = {}
        if gen_properties is not None and entry in gen_properties.index:
            row = gen_properties.loc[entry]
            extras = {"pt": np.float32(row["vp_pt"]),
                      "eta": np.float32(row["vp_eta"])}
        out.append((entry, g, extras))
    return out


def save_graphs(graphs: Iterable[Tuple[int, Graph, dict]], output_dir: str,
                stem: str = "graph") -> List[str]:
    """NPZ output with pt/eta extras (`Muon_graph.py:198-209`)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, (_, g, extras) in enumerate(graphs):
        path = os.path.join(output_dir, f"{stem}_{i:06d}.npz")
        save_npz(g, path, **extras)
        paths.append(path)
    return paths
