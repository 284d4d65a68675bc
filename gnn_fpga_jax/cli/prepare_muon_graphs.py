"""Muon-endcap graph-building CLI.

Counterpart of `/root/reference/gnn/prepareMuonGraphs.py`: pairs signal
(`*SingleMuon_Endcap.root`) with pileup (`*SingleNeutrino_PU200.root`)
files, runs the EMTF pipeline (`gnn_fpga_jax.data.muon`), writes NPZ
graphs with pt/eta, optionally plots each graph.

Also accepts parquet/CSV hit tables with the same columns when uproot
is unavailable (suffixes configurable).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import pandas as pd

from gnn_fpga_jax.data import muon


def parse_args(argv=None):
    parser = argparse.ArgumentParser("prepare_muon_graphs")
    add_arg = parser.add_argument
    add_arg("--input-muon-dir", required=True)
    add_arg("--input-pu-dir", required=True)
    add_arg("--muononly", action="store_true")
    add_arg("--max-files", type=int, default=1)
    add_arg("--start", type=int, default=0)
    add_arg("--end", type=int, default=100)
    add_arg("--output-dir", default="./")
    add_arg("--muon-suffix", default="SingleMuon_Endcap.root")
    add_arg("--pu-suffix", default="SingleNeutrino_PU200.root")
    add_arg("--plot", action="store_true", help="plot each saved graph")
    return parser.parse_args(argv)


def find_file_pairs(muon_dir, pu_dir, muon_suffix, pu_suffix, max_files):
    """Paired signal/PU files, sorted (`prepareMuonGraphs.py:127-136`)."""
    muon_files = sorted(glob.glob(os.path.join(muon_dir, "*" + muon_suffix)))
    pu_files = sorted(glob.glob(os.path.join(pu_dir, "*" + pu_suffix)))
    return list(zip(muon_files[:max_files], pu_files[:max_files]))


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    pairs = find_file_pairs(args.input_muon_dir, args.input_pu_dir,
                            args.muon_suffix, args.pu_suffix, args.max_files)
    logging.info("file pairs: %s", pairs)
    cfg = muon.MuonPipelineConfig(
        muon_only=args.muononly,
        entry_start=args.start, entry_stop=args.end)

    all_paths = []
    for muon_path, pu_path in pairs:
        logging.info("reading muon file: %s", muon_path)
        logging.info("reading pu file: %s", pu_path)
        df_muon = muon.load_ntuple(muon_path, args.start, args.end)
        df_pu = muon.load_ntuple(pu_path, args.start, args.end)
        try:
            gen = muon.load_ntuple(muon_path, args.start, args.end,
                                   branches=("vp_pt", "vp_eta"))
            gen = gen.groupby("entry").first() if "entry" in gen else gen
        except Exception:
            gen = None
        graphs = muon.build_graphs(df_muon, df_pu, gen_properties=gen, cfg=cfg)
        stem = "graph_" + os.path.basename(muon_path).rsplit(".", 1)[0]
        all_paths += muon.save_graphs(graphs, args.output_dir, stem=stem)

    logging.info("wrote %i graphs", len(all_paths))
    if args.plot:
        from gnn_fpga_jax.core.graph import load_npz_with_extras
        from gnn_fpga_jax.utils.plotting import draw_sample_with_properties
        plot_dir = os.path.join(args.output_dir, "plots")
        for path in all_paths:
            g, ex = load_npz_with_extras(path)
            name = os.path.basename(path).replace(".npz", "")
            draw_sample_with_properties(
                g, float(ex.get("pt", 0.0)), float(ex.get("eta", 0.0)),
                plot_dir, name)
    return all_paths


if __name__ == "__main__":
    main()
