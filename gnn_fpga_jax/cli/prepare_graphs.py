"""Graph-building CLI for TrackML-format data.

This framework's counterpart of `/root/reference/gnn/prepareGraphs.py`:
same flags and pipeline (hit selection -> phi sectors -> doublet graphs ->
NPZ shards), with the vectorised doublet engine and a
``multiprocessing.Pool`` over events.

Usage: python -m gnn_fpga_jax.cli.prepare_graphs --input-dir ... --output-dir ...
"""

from __future__ import annotations

import argparse
import functools
import logging
import multiprocessing as mp
import os
from typing import List, Optional

import numpy as np

from gnn_fpga_jax.core.graph import Graph, save_npz
from gnn_fpga_jax.data import doublets, selection, trackml_io


def parse_args(argv=None):
    parser = argparse.ArgumentParser("prepare_graphs")
    add_arg = parser.add_argument
    add_arg("--input-dir", required=True)
    add_arg("--output-dir")
    add_arg("--n-files", type=int, default=1)
    add_arg("--n-workers", type=int, default=1)
    add_arg("--pt-min", type=float, default=1, help="pt cut")
    add_arg("--n-tracks", type=int, help="Max tracks per event")
    add_arg("--phi-slope-max", type=float, default=0.001, help="phi slope cut")
    add_arg("--phi-slope-mid-max", type=float, default=0.001,
            help="phi slope middle cut")
    add_arg("--phi-slope-outer-max", type=float, default=0.001,
            help="phi slope outer cut")
    add_arg("--z0-max", type=float, default=200, help="z0 cut")
    add_arg("--n-phi-sectors", type=int, default=8,
            help="Break detector into number of phi sectors")
    add_arg("--select-phi-sector", action="store_true",
            help="select one phi sector")
    add_arg("--no-missing-hits", action="store_true",
            help="Require no missing hits")
    add_arg("--show-config", action="store_true")
    return parser.parse_args(argv)


def process_event(prefix: str, args) -> List[Optional[Graph]]:
    """One event -> one graph per phi sector (`prepareGraphs.py:136-170`)."""
    evtid = trackml_io.event_id_from_prefix(prefix)
    logging.info("Event %i, loading data", evtid)
    hits, particles, truth = trackml_io.load_event(prefix)
    hits = selection.select_hits(
        hits, truth, particles, pt_min=args.pt_min,
        no_missing_hits=args.no_missing_hits).assign(evtid=evtid)
    sectors = selection.split_phi_sectors(
        hits, n_phi_sectors=args.n_phi_sectors,
        select_phi_sector=args.select_phi_sector)
    feature_names = ["r", "phi", "z"]
    feature_scale = np.array([1000.0, np.pi / args.n_phi_sectors, 1000.0])
    cuts = doublets.SegmentCuts(
        phi_slope_max=args.phi_slope_max,
        phi_slope_mid_max=args.phi_slope_mid_max,
        phi_slope_outer_max=args.phi_slope_outer_max,
        z0_max=args.z0_max)
    layer_pairs = doublets.adjacent_layer_pairs(10)
    # nodes sorted by layer + per-node layer array saved into the NPZ:
    # what the train CLI needs to route loaded graphs onto the blocked
    # path (ops/blocked.py)
    return [doublets.construct_graph(
                sector, layer_pairs, cuts=cuts,
                feature_names=feature_names, feature_scale=feature_scale,
                max_tracks=args.n_tracks,
                no_missing_hits=args.no_missing_hits,
                sort_by_layer=True, return_layers=True)
            for sector in sectors]


def graphs_summary(graphs: List[Graph], n_true_expected: int = 90) -> dict:
    """Dataset summary incl. the reference's missing-true-edge accounting
    (`prepareGraphs.py:118-134`; 90 expected true edges = 10 tracks x 9
    layer pairs for mu10)."""
    n_nodes = [g.n_node for g in graphs]
    n_edges = [g.n_edge for g in graphs]
    n_true = [float(np.asarray(g.y).sum()) for g in graphs]
    n_missed = [n_true_expected - t for t in n_true]
    n_ev = max(len(graphs), 1)
    return {
        "n_events": len(graphs),
        "n_edges": int(sum(n_edges)),
        "edges_per_event": sum(n_edges) / n_ev,
        "nodes_per_event": sum(n_nodes) / n_ev,
        "mean_missed_true_edges": float(np.mean(n_missed)) if graphs else 0.0,
        "purity": (sum(n_true) / max(sum(n_edges), 1)),
    }


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.show_config:
        logging.info("Command line config: %s", args)

    prefixes = trackml_io.find_event_prefixes(args.input_dir, args.n_files)
    logging.info("Processing %i events with %i workers",
                 len(prefixes), args.n_workers)
    worker = functools.partial(process_event, args=args)
    if args.n_workers > 1:
        with mp.Pool(processes=args.n_workers) as pool:
            per_event = pool.map(worker, prefixes)
    else:
        per_event = [worker(p) for p in prefixes]
    pairs = [gl for gls in per_event for gl in gls if gl[0] is not None]
    graphs = [g for g, _ in pairs]

    summary = graphs_summary(graphs)
    logging.info("Graphs summary: %s", summary)

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        logging.info("Writing outputs to %s", args.output_dir)
        for i, (g, layers) in enumerate(pairs):
            save_npz(g, os.path.join(args.output_dir, f"graph{i:06d}.npz"),
                     layer=layers)
    return graphs


if __name__ == "__main__":
    main()
