"""Example: the FPGA compression workflow — iterative magnitude pruning.

The executable equivalent of
`/root/reference/gnn/MPNN_Seg_ACTS_maskedlinear.ipynb:cell21-24`: train a
dense model, then run threshold -> mask -> transplant -> L1-retrain
rounds, reporting per-layer mask cardinalities and metrics after each
round (the reference records e.g. Edge-L1 86/112 and acc 0.954 pruned).

Run:  python examples/pruning_rounds.py [--rounds 2] [--threshold 1e-2]
"""

import argparse

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--l1", type=float, default=1e-4)
    ap.add_argument("--hidden-dim", type=int, default=8)
    args = ap.parse_args()

    from gnn_fpga_jax.compress import pruning
    from gnn_fpga_jax.core import batching
    from gnn_fpga_jax.data import toy2d
    from gnn_fpga_jax.models import mpnn
    from gnn_fpga_jax.train.trainer import Trainer, TrainConfig

    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0)
    train_g = toy2d.make_segment_graphs(cfg, 1024)
    gen = batching.batch_generator(train_g, 32, seed=0)
    n_batches = 1024 // 32

    mcfg = mpnn.SegmentClassifierConfig(input_dim=2,
                                        hidden_dim=args.hidden_dim, n_iters=4)
    logits = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)

    # Round 0: dense training with the L1 penalty pushing weights to zero.
    tr = Trainer(logits, mpnn.init_segment_classifier(
        jax.random.PRNGKey(0), mcfg), TrainConfig(learning_rate=5e-3,
                                                  l1=args.l1))
    tr.fit(gen, n_batches=n_batches, n_epochs=args.epochs)
    print("dense:", {k: round(float(v), 4)
                     for k, v in tr.evaluate(gen, 8).items()})

    params = tr.params
    for rnd in range(1, args.rounds + 1):
        # threshold -> masks (`cell21`)
        masked_params, masks = pruning.prune_round(params, args.threshold)
        print(f"round {rnd} masks:", pruning.mask_summary(masks),
              f"sparsity={pruning.sparsity(masks):.3f}")
        # rebuild + transplant + L1 retrain (`cell22-24`)
        tr = Trainer(logits, mpnn.init_segment_classifier(
            jax.random.PRNGKey(rnd), mcfg),
            TrainConfig(learning_rate=5e-3, l1=args.l1), masks=masks)
        tr.load_weights(params)
        tr.fit(gen, n_batches=n_batches, n_epochs=args.epochs)
        print(f"round {rnd}:", {k: round(float(v), 4)
                                for k, v in tr.evaluate(gen, 8).items()})
        params = tr.params

    n_nonzero = sum(int((np.asarray(m) != 0).sum())
                    for lm in masks.values() for m in lm.values())
    print(f"final nonzero masked weights: {n_nonzero} "
          f"(of {mpnn.count_params(params)} total params)")


if __name__ == "__main__":
    main()
