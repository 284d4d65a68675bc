"""Training CLI for the segment classifier.

Counterpart of `/root/reference/gnn/trainSegmentClassifier.py:46-211`:
load NPZ graphs, partition train/valid/test rounded to batch multiples,
train with the jitted engine, report accuracy/precision/recall (+AUC),
save model params and loss histories.

Unlike the reference's single dense path, this CLI exposes every route
the benchmark runs:

- ``--aggregation dense|sparse|blocked``: the aggregation layout (see
  `models/mpnn.py`).  ``blocked`` is per-layer-pair block-diagonal
  incidence (`ops/blocked.py`) and needs per-node ``layer`` arrays in
  the NPZ graphs — the prepare CLI writes them; offsets may differ per
  graph (per-event layer populations), handled by batched layer
  offsets.
- ``--bf16``: bf16 compute (f32 master weights), halves HBM traffic.
- ``--strategy dp``: data parallel over all devices (GSPMD batch-axis
  sharding).  ``--strategy partitioned``: graph/context parallel — each
  packed batch is halo-partitioned across the mesh
  (`parallel/partition.py`) and aggregated with XLA segment-sums.
- ``--lr-schedule cosine``: cosine decay over the training run.

Usage: python -m gnn_fpga_jax.cli.train --input-dir ... [--output-dir ...]
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import jax
import numpy as np

from gnn_fpga_jax.core import batching
from gnn_fpga_jax.core.graph import load_npz_with_extras, layer_offsets_from_layers
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.train.trainer import Trainer, TrainConfig
from gnn_fpga_jax.utils.compile_cache import enable_compile_cache


def parse_args(argv=None):
    parser = argparse.ArgumentParser("train")
    add_arg = parser.add_argument
    add_arg("--input-dir", required=True)
    add_arg("--output-dir")
    add_arg("--n-samples", type=int, default=1024)
    add_arg("--valid-frac", type=float, default=0.1)
    add_arg("--test-frac", type=float, default=0.1)
    add_arg("--n-epochs", type=int, default=10)
    add_arg("--batch-size", type=int, default=32)
    add_arg("--hidden-dim", type=int, default=8)
    add_arg("--n-iters", type=int, default=3)
    add_arg("--learning-rate", type=float, default=1e-3)
    add_arg("--l1", type=float, default=0.0)
    add_arg("--pos-weight", type=float, default=1.0,
            help="BCE weight on positive edges (~n_fake/n_true escapes "
                 "base-rate collapse on high-pileup graphs)")
    add_arg("--aggregation", default="auto",
            choices=["auto", "dense", "sparse", "blocked"],
            help="aggregation layout: blocked = layered block incidence "
                 "(needs 'layer' arrays in the NPZ, prepare_graphs writes "
                 "them); auto picks dense for small graphs")
    # 4 was chosen on earlier hardware; not yet measured on the H100
    # (ROADMAP.md queue 1 item 3).
    add_arg("--group", type=int, default=4,
            help="blocked path: layer pairs merged per block")
    add_arg("--bf16", action="store_true",
            help="bf16 compute dtype (f32 master weights)")
    add_arg("--strategy", default="single",
            choices=["single", "dp", "partitioned"],
            help="dp = data parallel over all devices; partitioned = "
                 "halo-partitioned packed batches over the mesh graph "
                 "axis (large-graph regime)")
    add_arg("--lr-schedule", default="constant",
            choices=["constant", "cosine"])
    add_arg("--prefetch", type=int, default=2,
            help="host batches prefetched to device ahead of the train "
                 "step (0 disables)")
    add_arg("--seed", type=int, default=0)
    add_arg("--n-buckets", type=int, default=1,
            help="size buckets for padding (one XLA compile per bucket; "
                 ">1 cuts padding waste on heavy-tailed size mixes)")
    add_arg("--resume", action="store_true",
            help="resume from checkpoint in output-dir")
    add_arg("--train-verbosity", type=int, default=0)
    add_arg("--show-config", action="store_true")
    return parser.parse_args(argv)


def load_graph_files(input_dir: str, n_samples: int):
    """NPZ graphs (plus extras: per-node ``layer``, pt/eta, ...) from a
    directory (`trainSegmentClassifier.py:128-131`)."""
    files = sorted(glob.glob(os.path.join(input_dir, "*.npz")))[:n_samples]
    if not files:
        raise FileNotFoundError(f"no NPZ graphs under {input_dir}")
    loaded = [load_npz_with_extras(f) for f in files]
    graphs = [g for g, _ in loaded]
    layers = [ex.get("layer") for _, ex in loaded]
    return graphs, layers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class BlockedSetup:
    """Dataset-wide static capacities + per-split transforms for the
    blocked path: per-graph layer offsets (real datasets have different
    layer populations per event) with pinned (block_e, block_n) so every
    batch compiles to one shape."""

    def __init__(self, graphs, layers, group: int):
        if any(l is None for l in layers):
            raise ValueError(
                "--aggregation blocked needs per-node 'layer' arrays in "
                "the NPZ graphs; re-run gnn_fpga_jax.cli.prepare_graphs "
                "(it sorts hits by layer and writes the arrays)")
        self.group = group
        self.n_layers = max(int(np.asarray(l).max()) for l in layers) + 1
        n_pairs = self.n_layers - 1
        if n_pairs < 1:
            raise ValueError("blocked path needs >= 2 detector layers")
        n_blocks = _round_up(n_pairs, group) // group
        lo_idx = np.arange(n_blocks) * group
        hi_idx = np.minimum(lo_idx + group + 1, self.n_layers)
        be = bn = 8
        offsets = []
        for g, lay in zip(graphs, layers):
            off = layer_offsets_from_layers(lay, self.n_layers)
            offsets.append(off)
            pair = np.searchsorted(off, np.asarray(g.senders),
                                   side="right") - 1
            cnt = np.bincount(np.clip(pair, 0, n_pairs - 1) // group,
                              minlength=n_blocks)
            be = max(be, int(cnt.max()))
            bn = max(bn, int((off[hi_idx] - off[lo_idx]).max()))
        self.block_e = _round_up(be, 8)
        self.block_n = _round_up(bn, 8)
        self._offsets = {id(g): off for g, off in zip(graphs, offsets)}

    def transform_for(self, split_graphs):
        from gnn_fpga_jax.ops import blocked as blk
        offs = [self._offsets[id(g)] for g in split_graphs]

        def transform(batch, idx):
            off_b = np.stack([offs[i] for i in idx])
            return blk.attach_blocks_layered(
                batch, off_b, group=self.group,
                block_e=self.block_e, block_n=self.block_n)

        return transform


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    enable_compile_cache()
    if args.show_config:
        logging.info("Command line config: %s", args)

    logging.info("Loading input graphs")
    graphs, layer_arrays = load_graph_files(args.input_dir, args.n_samples)
    n = len(graphs)

    # Partition sizes rounded to batch multiples
    # (`trainSegmentClassifier.py:133-140`).
    bs = args.batch_size
    n_test = int(n * args.test_frac) // bs * bs
    n_valid = int(n * args.valid_frac) // bs * bs
    n_train = (n - n_valid - n_test) // bs * bs
    if n_train <= 0:
        raise ValueError(f"no training data: {n} graphs, batch {bs}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    test_graphs = [graphs[i] for i in order[:n_test]]
    valid_graphs = [graphs[i] for i in order[n_test:n_test + n_valid]]
    train_graphs = [graphs[i] for i in order[n_test + n_valid:
                                             n_test + n_valid + n_train]]
    logging.info("Train set size: %i", len(train_graphs))
    logging.info("Valid set size: %i", len(valid_graphs))
    logging.info("Test set size:  %i", len(test_graphs))

    # --- route selection ---------------------------------------------------
    agg = args.aggregation
    packed = args.strategy == "partitioned"
    if packed and agg in ("dense", "blocked"):
        raise ValueError(
            f"--aggregation {agg} does not combine with --strategy "
            "partitioned: the sharded forward aggregates with XLA "
            "segment-sums only (use sparse or auto)")

    # One shared bucket keeps a single compiled train step; --n-buckets > 1
    # trades compiles for less padding (heavy-tailed event-size mixes).
    if args.n_buckets > 1 and not packed:
        bucket = batching.choose_buckets(graphs, args.n_buckets)
        logging.info("Buckets: %s (padding efficiency %.2f -> %.2f)",
                     bucket,
                     batching.padding_efficiency(
                         graphs, batching.choose_bucket(graphs), bs),
                     batching.padding_efficiency(graphs, bucket, bs))
    else:
        bucket = batching.choose_bucket(graphs)

    blocked_setup = None
    if agg == "blocked":
        blocked_setup = BlockedSetup(graphs, layer_arrays, args.group)
        logging.info("Blocked plan: %i layers, group %i, block_e %i, "
                     "block_n %i", blocked_setup.n_layers, args.group,
                     blocked_setup.block_e, blocked_setup.block_n)

    part_caps = None
    mesh = None
    if args.strategy == "partitioned":
        from gnn_fpga_jax.parallel import mesh as mesh_lib
        from gnn_fpga_jax.parallel import partition as part
        n_dev = len(jax.devices())
        mesh = mesh_lib.make_mesh((n_dev,), (mesh_lib.GRAPH_AXIS,))
        # pre-scan a deterministic epoch for the worst-case shard shapes,
        # pin with headroom (shuffled epochs regroup graphs; violations
        # raise a clear error rather than recompiling silently)
        probe = batching.batch_generator(train_graphs, bs, bucket,
                                         shuffle=False, packed=True)
        max_e = s_pair = 1
        for _ in range(max(len(train_graphs) // bs, 1)):
            pg = part.partition_graph(next(probe), n_dev)
            max_e = max(max_e, pg.senders.shape[-1])
            s_pair = max(s_pair, pg.halo_size)
        part_caps = dict(
            edge_capacity=_round_up(int(max_e * 1.25), 8),
            halo_capacity=_round_up(int(s_pair * 1.25), 8))
        logging.info("Partitioned over %i devices: edge_capacity %i, "
                     "halo_capacity %i", n_dev,
                     part_caps["edge_capacity"], part_caps["halo_capacity"])

        def part_transform_for(split_graphs):
            def transform(batch, idx):
                return part.partition_graph(batch, n_dev, **part_caps)
            return transform
    elif args.strategy == "dp":
        from gnn_fpga_jax.parallel import mesh as mesh_lib
        n_dev = len(jax.devices())
        if bs % n_dev:
            raise ValueError(f"--batch-size {bs} not divisible by "
                             f"{n_dev} devices for --strategy dp")
        mesh = mesh_lib.make_mesh((n_dev,), (mesh_lib.DATA_AXIS,))

    def transform_for(split_graphs):
        if args.strategy == "partitioned":
            return part_transform_for(split_graphs)
        if blocked_setup is not None:
            return blocked_setup.transform_for(split_graphs)
        return None

    def make_gen(split_graphs, shuffle, seed=0):
        return batching.batch_generator(
            split_graphs, bs, bucket, shuffle=shuffle, seed=seed,
            packed=packed, transform=transform_for(split_graphs))

    train_gen = make_gen(train_graphs, shuffle=True, seed=args.seed)
    if args.prefetch > 0:
        from gnn_fpga_jax.core.prefetch import prefetch_to_device
        train_gen = prefetch_to_device(train_gen, size=args.prefetch)
    valid_gen = make_gen(valid_graphs, shuffle=False) if n_valid else None
    test_gen = make_gen(test_graphs, shuffle=False) if n_test else None

    logging.info("Building the model")
    import jax.numpy as jnp
    n_features = graphs[0].n_feature
    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=n_features, hidden_dim=args.hidden_dim,
        n_iters=args.n_iters, aggregation=agg,
        compute_dtype=jnp.bfloat16 if args.bf16 else None)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(args.seed), mcfg)
    n_batches = len(train_graphs) // bs
    tcfg = TrainConfig(learning_rate=args.learning_rate, l1=args.l1,
                       pos_weight=args.pos_weight,
                       lr_schedule=args.lr_schedule,
                       decay_steps=max(args.n_epochs * n_batches, 1))
    ckpt_dir = (os.path.join(args.output_dir, "checkpoints")
                if args.output_dir else None)
    metrics_path = (os.path.join(args.output_dir, "metrics.jsonl")
                    if args.output_dir else None)
    trainer = Trainer(
        lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m),
        params, tcfg, checkpoint_dir=ckpt_dir, metrics_path=metrics_path,
        strategy=args.strategy, mesh=mesh, model_cfg=mcfg)
    if args.resume and trainer.load_checkpoint():
        logging.info("Resumed from epoch %i", trainer.epoch)

    try:
        trainer.fit(train_gen, n_batches=n_batches,
                    n_epochs=args.n_epochs,
                    valid_generator=valid_gen,
                    n_valid_batches=(n_valid // bs),
                    verbose=args.train_verbosity)
    finally:
        if args.prefetch > 0:
            train_gen.close()

    if test_gen is not None:
        logging.info("Evaluating the test set")
        metrics = trainer.evaluate(test_gen, n_test // bs)
        for k, v in metrics.items():
            logging.info("%s: %.4f", k.capitalize(), v)

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        logging.info("Writing outputs to %s", args.output_dir)
        from gnn_fpga_jax.utils.serialization import save_params_npz
        save_params_npz(os.path.join(args.output_dir, "model.npz"),
                        trainer.params)
        np.savez(os.path.join(args.output_dir, "losses.npz"),
                 train_losses=np.asarray(trainer.train_losses),
                 valid_losses=np.asarray(trainer.valid_losses))
    logging.info("All done!")
    return trainer


if __name__ == "__main__":
    main()
