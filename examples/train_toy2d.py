"""Example: Toy2D segment classification end-to-end.

The executable equivalent of `/root/reference/gnn/MPNN_Seg_Toy2D.ipynb`:
generate straight-track toy events, train the shared-weight
SegmentClassifier, evaluate, and plot an event display + ROC.

Run:  python examples/train_toy2d.py  [--epochs 40]
"""

import argparse
import os

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--events", type=int, default=2048)
    ap.add_argument("--hidden-dim", type=int, default=32)
    ap.add_argument("--n-iters", type=int, default=4)
    ap.add_argument("--out", default="/tmp/toy2d_example")
    args = ap.parse_args()

    from gnn_fpga_jax.core import batching
    from gnn_fpga_jax.data import toy2d
    from gnn_fpga_jax.models import mpnn
    from gnn_fpga_jax.train.trainer import Trainer, TrainConfig
    from gnn_fpga_jax.utils import plotting

    cfg = toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0)
    train_g = toy2d.make_segment_graphs(cfg, args.events)
    valid_g = toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=1), args.events // 4)

    batch = 32
    gen = batching.batch_generator(train_g, batch, seed=0)
    vgen = batching.batch_generator(valid_g, batch, shuffle=False)

    mcfg = mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=args.hidden_dim, n_iters=args.n_iters)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), mcfg)
    tr = Trainer(lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m),
                 params, TrainConfig(learning_rate=5e-3),
                 checkpoint_dir=os.path.join(args.out, "ckpt"))
    tr.fit(gen, n_batches=args.events // batch, n_epochs=args.epochs,
           valid_generator=vgen, n_valid_batches=args.events // 4 // batch)

    metrics = tr.evaluate(vgen, args.events // 4 // batch)
    print("validation:", {k: round(float(v), 4) for k, v in metrics.items()})

    os.makedirs(args.out, exist_ok=True)
    preds, targets, mask = tr.predict(vgen, 4)
    plotting.plot_roc(targets, preds, mask,
                      filename=os.path.join(args.out, "roc.png"))
    plotting.plot_losses(tr.train_losses, tr.valid_losses,
                         filename=os.path.join(args.out, "losses.png"))
    one = jax.tree.map(lambda a: a[0], valid_g)
    scores = np.asarray(mpnn.segment_classifier(tr.params, jax.tree.map(
        jax.numpy.asarray, one), mcfg))
    plotting.draw_sample(one, e=scores, skip_false_edges=False,
                         axes_features=((1, 0), (1, 0)),
                         axis_labels=(("$r$", "$x$"), ("$r$", "$x$")),
                         filename=os.path.join(args.out, "event.png"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
