"""Standalone inference CLI.

Counterpart of `/root/reference/gnn/Inference.ipynb`: load a trained
(possibly pruned, FPGA-sized) model checkpoint and score saved graphs —
the latency-benchmark entry point for the 189-parameter deployment model
(hidden_dim 4, n_iters 1, `Inference.ipynb:cell2`).

Usage: python -m gnn_fpga_jax.cli.infer --model ... --input-dir ... \
           [--hidden-dim 4 --n-iters 1]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time

import jax
import numpy as np

from gnn_fpga_jax.core import batching
from gnn_fpga_jax.core.graph import load_npz
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.utils.compile_cache import enable_compile_cache


def parse_args(argv=None):
    parser = argparse.ArgumentParser("infer")
    add_arg = parser.add_argument
    add_arg("--model", required=True, help="model.npz from the train CLI")
    add_arg("--input-dir", required=True)
    add_arg("--n-graphs", type=int, default=1)
    add_arg("--hidden-dim", type=int, default=4)
    add_arg("--n-iters", type=int, default=1)
    add_arg("--output")
    add_arg("--benchmark", action="store_true",
            help="time the jitted forward after warmup")
    return parser.parse_args(argv)


def load_params(path: str):
    """Rebuild the params pytree from the NPZ written by the train CLI
    (path-table format; legacy keystr files still load — see
    gnn_fpga_jax/utils/serialization.py)."""
    from gnn_fpga_jax.utils.serialization import load_params_npz
    return load_params_npz(path)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    enable_compile_cache()
    params = load_params(args.model)
    logging.info("Parameters: %i", mpnn.count_params(params))

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.npz")))
    files = files[:args.n_graphs]
    graphs = [load_npz(f) for f in files]
    input_dim = graphs[0].n_feature
    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=input_dim, hidden_dim=args.hidden_dim,
        n_iters=args.n_iters)

    bucket = batching.choose_bucket(graphs)
    forward = jax.jit(
        lambda p, g: mpnn.segment_classifier(p, g, mcfg))
    results = []
    from gnn_fpga_jax.core.graph import pad_graph
    for path, g in zip(files, graphs):
        gp = jax.tree.map(jax.numpy.asarray,
                          pad_graph(g, bucket.n_node, bucket.n_edge))
        scores = np.asarray(forward(params, gp))
        em = np.asarray(gp.edge_mask) > 0
        results.append({"file": os.path.basename(path),
                        "n_edges": int(em.sum()),
                        "mean_score": float(scores[em].mean())})
        logging.info("%s: %i edges, mean score %.4f",
                     path, int(em.sum()), float(scores[em].mean()))

    if args.benchmark:
        gp = jax.tree.map(jax.numpy.asarray,
                          pad_graph(graphs[0], bucket.n_node, bucket.n_edge))
        forward(params, gp)[0].block_until_ready()  # warmup/compile
        n_rep = 100
        t0 = time.perf_counter()
        for _ in range(n_rep):
            out = forward(params, gp)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / n_rep
        logging.info("Latency: %.1f us/graph", dt * 1e6)

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
