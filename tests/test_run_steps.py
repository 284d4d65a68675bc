"""Scan-based multi-step training (`Trainer.run_steps` / `fit_stacked`):
one device dispatch per epoch must be numerically identical to the
per-step path."""

import jax
import numpy as np

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.train.trainer import (
    Trainer, TrainConfig, stack_batches)


def _setup(seed=0):
    cfg = toy2d.Toy2DConfig(n_layers=6, n_tracks=3, seed=seed)
    g = toy2d.make_segment_graphs(cfg, 8 * 4)
    batches = [jax.tree.map(lambda a: a[i * 8:(i + 1) * 8], g)
               for i in range(4)]
    mcfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=2)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), mcfg)
    return batches, params, mcfg


def test_run_steps_matches_per_step_path():
    batches, params, mcfg = _setup()
    logits_fn = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)

    copy = lambda p: jax.tree.map(lambda a: a.copy(), p)
    tr_a = Trainer(logits_fn, copy(params), TrainConfig(learning_rate=5e-3))
    losses_a = []
    for b in batches:
        tr_a.params, tr_a.opt_state, loss = tr_a._train_step(
            tr_a.params, tr_a.opt_state, b)
        losses_a.append(float(loss))

    tr_b = Trainer(logits_fn, copy(params), TrainConfig(learning_rate=5e-3))
    losses_b = tr_b.run_steps(stack_batches(batches))

    np.testing.assert_allclose(losses_b, losses_a, rtol=1e-5)
    for pa, pb in zip(jax.tree.leaves(tr_a.params), jax.tree.leaves(tr_b.params)):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                   rtol=1e-5, atol=1e-6)


def test_fit_stacked_trains_and_records(tmp_path):
    batches, params, mcfg = _setup(seed=3)
    logits_fn = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)
    tr = Trainer(logits_fn, params, TrainConfig(learning_rate=5e-3),
                 checkpoint_dir=str(tmp_path / "ckpt"),
                 metrics_path=str(tmp_path / "metrics.jsonl"))
    stacked = stack_batches(batches)
    tr.fit_stacked(stacked, n_epochs=8, valid_batch=batches[0])
    assert len(tr.train_losses) == 8
    assert len(tr.valid_losses) == 8
    assert tr.train_losses[-1] < tr.train_losses[0]
    assert (tmp_path / "metrics.jsonl").exists()
