"""Graph visualisation CLI over saved NPZ graphs.

Counterpart of `/root/reference/gnn/PlotGraph.py`: load saved muon graphs
(with pt/eta extras), apply the pt/eta quality cuts, render with
``draw_sample_with_properties``.

Usage: python -m gnn_fpga_jax.cli.plot_graph --directory ... --outputname ...
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

from gnn_fpga_jax.core.graph import load_npz_with_extras
from gnn_fpga_jax.utils.plotting import draw_sample_with_properties


def parse_args(argv=None):
    parser = argparse.ArgumentParser("plot_graph")
    add_arg = parser.add_argument
    add_arg("--directory", required=True, help="directory of graph NPZs")
    add_arg("--outputname", default="plots", help="output directory")
    add_arg("--ngraphs", type=int, default=10)
    add_arg("--pt-min", type=float, default=20.0,
            help="min generated pt (`PlotGraph.py:32`)")
    add_arg("--eta-range", type=float, nargs=2, default=(1.2, 2.4),
            help="|eta| window (`PlotGraph.py:32`)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    files = sorted(glob.glob(os.path.join(args.directory, "*.npz")))
    n_drawn = 0
    for path in files:
        if n_drawn >= args.ngraphs:
            break
        g, extras = load_npz_with_extras(path)
        pt = float(extras.get("pt", 0.0))
        eta = float(extras.get("eta", 0.0))
        lo, hi = args.eta_range
        if pt > args.pt_min and lo < abs(eta) < hi:
            name = os.path.basename(path).replace(".npz", "")
            draw_sample_with_properties(g, pt, eta, args.outputname, name)
            n_drawn += 1
            logging.info("drew %s (pt=%.1f eta=%.2f)", name, pt, eta)
    logging.info("drew %i graphs", n_drawn)
    return n_drawn


if __name__ == "__main__":
    main()
