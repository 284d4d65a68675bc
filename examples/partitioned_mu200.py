"""Example: training on one large (mu200-scale) graph partitioned across
a device mesh — the capability the reference lacks (it fell back to batch=2
and subsampling at 200 pileup, `MPNN_Seg_ACTS_mu200.ipynb`).

The full engine (fit / eval / checkpointing / metrics) is the same
Trainer as single-device training — only ``strategy="partitioned"``
changes.  Boundary-node halo exchange keeps per-device activation memory
at [N/P + halo, D] (see parallel/partition.py).

On a CPU host, exercise with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/partitioned_mu200.py
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-tracks", type=int, default=48,
                    help="tracks per event (~mu200 occupancy when large)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--n-iters", type=int, default=6)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision sharded forward")
    args = ap.parse_args()

    from gnn_fpga_jax.data import toy2d
    from gnn_fpga_jax.models import mpnn
    from gnn_fpga_jax.parallel import mesh as mesh_lib
    from gnn_fpga_jax.parallel import partition
    from gnn_fpga_jax.train.trainer import Trainer, TrainConfig

    n_dev = len(jax.devices())
    print(f"{n_dev} devices: {jax.devices()}")
    mesh = mesh_lib.make_mesh((n_dev,), (mesh_lib.GRAPH_AXIS,))

    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=args.n_tracks, seed=0)
    big = jax.tree.map(lambda a: a[0], toy2d.make_segment_graphs(cfg, 1))
    print(f"graph: {big.n_node} nodes, {big.n_edge} edges")
    pg = jax.tree.map(jnp.asarray, partition.partition_graph(big, n_dev))
    print(f"partitioned: {pg.n_parts} shards x {pg.n_local} nodes, "
          f"{pg.senders.shape[1]} edges/shard, halo {pg.halo_size}/pair")

    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=args.hidden_dim, n_iters=args.n_iters,
        compute_dtype=jnp.bfloat16 if args.bf16 else None)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), mcfg)

    trainer = Trainer(None, params, TrainConfig(),
                      strategy="partitioned", mesh=mesh, model_cfg=mcfg)

    def gen():
        while True:
            yield pg

    n_edges = int(np.asarray(big.edge_mask).sum())
    t0 = time.perf_counter()
    trainer.fit(gen(), n_batches=args.steps, n_epochs=1)
    dt = time.perf_counter() - t0
    print(f"loss {trainer.train_losses[-1]:.4f}; "
          f"{args.steps * n_edges / dt / 1e6:.1f}M edges/s "
          f"over {n_dev} devices (incl. compile)")
    m = trainer.evaluate(gen(), 1)
    print({k: round(v, 4) for k, v in m.items()})


if __name__ == "__main__":
    main()
