#!/usr/bin/env python3
"""Scaling-efficiency harness: edges/s/chip vs device count on the GPUs of
one host, for both parallel modes:

- **dp**: data parallelism — batched graphs sharded on the mesh ``data``
  axis (gradient all-reduce derived by GSPMD).
- **partitioned**: graph (context) parallelism — one large graph
  row-partitioned with boundary halo exchange (parallel/partition.py).

One process drives every card.  ``main`` refuses to run without a GPU;
``run_mode`` itself also runs on a virtual CPU mesh, which the tests use
to check the mechanics.

Prints one JSON line per mode:
  {"metric": "scaling_efficiency_<mode>", "value": eff_at_max_devices,
   "unit": "fraction", "per_device_counts": {...}, "platform": ...,
   "device_kind": ..., "device_count": ..., "card": ...}
"""

from __future__ import annotations

import argparse
import json
import time


def _timed_steps(step, params, opt_state, batch, n_steps, n_warmup=3):
    import jax

    for _ in range(n_warmup):
        params, opt_state, loss = step(params, opt_state, batch)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state, batch)
    jax.block_until_ready(loss)
    return time.perf_counter() - t0


def _fullevent_graph(n_sectors=36, n_layers=20, n_tracks=22, k=12):
    """One packed V~16k/E~217k kNN graph — the mu200 full-event regime
    (bench.py fullevent metric), for partitioned strong scaling."""
    import jax
    from gnn_fpga_jax.core import graph as graph_lib
    from gnn_fpga_jax.data import toy2d

    gs = toy2d.make_knn_segment_graphs(
        toy2d.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=0),
        n_sectors, k=k)
    return graph_lib.pack_graphs(graph_lib.unbatch_graphs(gs))


def run_mode(mode: str, device_counts, n_steps: int, hidden: int,
             n_iters: int, n_tracks: int, batch: int,
             scale: str = "sector"):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gnn_fpga_jax.data import toy2d
    from gnn_fpga_jax.models import mpnn
    from gnn_fpga_jax.parallel import mesh as mesh_lib
    from gnn_fpga_jax.parallel import partition
    from gnn_fpga_jax.parallel import data_parallel as dp
    from gnn_fpga_jax.train.trainer import TrainConfig

    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=hidden, n_iters=n_iters,
        aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), mcfg)
    optimizer = optax.adam(1e-3)
    results = {}
    for n_dev in device_counts:
        devices = jax.devices()[:n_dev]
        if mode == "dp":
            # weak scaling: batch per device fixed
            g = toy2d.make_segment_graphs(
                toy2d.Toy2DConfig(n_layers=10, n_tracks=n_tracks, seed=0),
                batch * n_dev)
            n_edges = int(np.asarray(g.edge_mask).sum())
            mesh = mesh_lib.make_mesh((n_dev,), (mesh_lib.DATA_AXIS,),
                                      devices=devices)
            step = dp.make_dp_train_step(
                lambda p, gr, m: mpnn.segment_classifier_logits(
                    p, gr, mcfg, m),
                optimizer, mesh, TrainConfig(), donate=False)
            batch_dev = jax.tree.map(
                lambda a: jnp.asarray(a) if a is not None else None, g)
        else:
            # strong scaling: one large graph split over devices
            if scale == "fullevent":
                g = _fullevent_graph()
            else:
                g = jax.tree.map(lambda a: a[0], toy2d.make_segment_graphs(
                    toy2d.Toy2DConfig(n_layers=10,
                                      n_tracks=n_tracks * batch,
                                      seed=0), 1))
            n_edges = int(np.asarray(g.edge_mask).sum())
            mesh = mesh_lib.make_mesh((n_dev,), (mesh_lib.GRAPH_AXIS,),
                                      devices=devices)
            step = partition.make_sharded_train_step(optimizer, mesh, mcfg)
            batch_dev = jax.tree.map(jnp.asarray,
                                     partition.partition_graph(g, n_dev))
        opt_state = optimizer.init(params)
        dt = _timed_steps(step, params, opt_state, batch_dev, n_steps)
        eps = n_steps * n_edges / dt
        results[n_dev] = {"edges_per_s": eps,
                          "edges_per_s_per_chip": eps / n_dev}
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["dp", "partitioned", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--n-iters", type=int, default=4)
    ap.add_argument("--n-tracks", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device-counts", type=int, nargs="*")
    ap.add_argument("--scale", choices=["sector", "fullevent"],
                    default="sector",
                    help="partitioned-mode graph size: 'fullevent' = one "
                    "packed V~16k/E~217k kNN graph (bench.py fullevent "
                    "regime)")
    args = ap.parse_args(argv)

    import jax

    from gnn_fpga_jax.utils.compile_cache import enable_compile_cache
    from gnn_fpga_jax.utils.device import device_record, require_gpu

    require_gpu()
    enable_compile_cache()
    n = len(jax.devices())
    counts = args.device_counts or [c for c in (1, 2, 4, 8) if c <= n]
    modes = ["dp", "partitioned"] if args.mode == "both" else [args.mode]
    for mode in modes:
        res = run_mode(mode, counts, args.steps, args.hidden, args.n_iters,
                       args.n_tracks, args.batch, scale=args.scale)
        base = res[counts[0]]["edges_per_s_per_chip"]
        eff = res[counts[-1]]["edges_per_s_per_chip"] / base
        suffix = "_fullevent" if (args.scale == "fullevent"
                                  and mode == "partitioned") else ""
        record = {
            "metric": f"scaling_efficiency_{mode}{suffix}",
            "value": round(eff, 3),
            "unit": "fraction",
            "devices": counts,
            "per_device_counts": {
                str(k): {kk: round(vv, 1) for kk, vv in v.items()}
                for k, v in res.items()},
            **device_record(),
        }
        print(json.dumps(record))


if __name__ == "__main__":
    main()
