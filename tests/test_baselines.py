"""Baseline (non-GNN) models: shapes, loss helpers, and convergence on the
toy tasks the reference uses them for (`MPNN_Seg_Toy2D.ipynb:cell15`,
`HitClustering_Toy2D.ipynb:cell13,24`, `Graph_dev.ipynb:cell12,20,28`)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import baselines as bl


CFG = toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=7)


def _fit(loss_fn, params, steps=250, lr=3e-3):
    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, loss

    for _ in range(steps):
        params, state, loss = step(params, state)
    return params, float(loss)


def test_softmax_xent_and_accuracy():
    logits = jnp.array([[2.0, -1.0, 0.0], [0.0, 3.0, -2.0]])
    targets = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    xent = bl.softmax_xent(logits, targets)
    expected = -np.mean([jax.nn.log_softmax(logits[i])[np.argmax(targets[i])]
                         for i in range(2)])
    assert np.isclose(float(xent), expected, rtol=1e-6)
    assert float(bl.row_accuracy(logits, targets)) == 1.0


def test_fc_segment_classifier_trains_on_toy_segments():
    g = toy2d.make_segment_graphs(CFG, 512)
    n_node = CFG.n_layers * CFG.n_tracks
    cfg = bl.FCSegmentClassifierConfig(
        n_hits=n_node, n_segments=g.senders.shape[1], input_dim=2,
        hidden_dim=64)
    params = bl.init_fc_segment_classifier(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(g.x)
    y = jnp.asarray(g.y)

    out = bl.fc_segment_classifier_logits(params, x, cfg)
    assert out.shape == y.shape

    def loss_fn(p):
        logits = bl.fc_segment_classifier_logits(p, x, cfg)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    params, _ = _fit(loss_fn, params, steps=400)
    preds = bl.fc_segment_classifier(params, x, cfg)
    acc = float(((preds > 0.5) == (y > 0.5)).mean())
    assert acc > 0.8, acc  # FC baseline separates the toy task


def test_fc_segmenter_converges():
    grids, targets = toy2d.make_segmenter_data(CFG, 1024)
    cfg = bl.SegmenterConfig(n_layers=CFG.n_layers, n_tracks=CFG.n_tracks,
                             hidden_dim=64)
    params = bl.init_fc_segmenter(jax.random.PRNGKey(1), cfg)
    grids, targets = jnp.asarray(grids), jnp.asarray(targets)
    assert bl.fc_segmenter_logits(params, grids, cfg).shape == targets.shape

    def loss_fn(p):
        return bl.softmax_xent(bl.fc_segmenter_logits(p, grids, cfg), targets)

    params, _ = _fit(loss_fn, params, steps=400)
    acc = float(bl.row_accuracy(bl.fc_segmenter_logits(params, grids, cfg),
                                targets))
    assert acc > 0.85, acc


def test_conv_segmenter_shapes_and_learns():
    grids, targets = toy2d.make_segmenter_data(CFG, 256)
    cfg = bl.ConvSegmenterConfig(n_layers=CFG.n_layers, n_tracks=CFG.n_tracks,
                                 adj_filters=(16, 16), lay_filters=(8,))
    params = bl.init_conv_segmenter(jax.random.PRNGKey(2), cfg)
    grids, targets = jnp.asarray(grids), jnp.asarray(targets)
    logits = bl.conv_segmenter_logits(params, grids, cfg)
    assert logits.shape == targets.shape
    probs = bl.conv_segmenter(params, grids, cfg)
    np.testing.assert_allclose(np.asarray(probs.sum(-1)), 1.0, rtol=1e-5)

    def loss_fn(p):
        return bl.softmax_xent(bl.conv_segmenter_logits(p, grids, cfg), targets)

    loss0 = float(loss_fn(params))
    params, loss1 = _fit(loss_fn, params, steps=120)
    assert loss1 < loss0


def test_stack_adjacent_features_boundaries():
    x = jnp.arange(2 * 3 * 2 * 1, dtype=jnp.float32).reshape(2, 3, 2, 1)
    s = bl.stack_adjacent_features(x)
    b, nl, nt, f = x.shape
    assert s.shape == (b, nl, nt, f + 2 * nt * f)
    # first layer has no backward features, last layer no forward features
    assert float(jnp.abs(s[:, 0, :, : nt * f]).max()) == 0.0
    assert float(jnp.abs(s[:, -1, :, -nt * f:]).max()) == 0.0
    # middle layer's backward block = layer-0 features for every slot
    np.testing.assert_array_equal(
        np.asarray(s[0, 1, 0, : nt * f]), np.asarray(x[0, 0].reshape(-1)))


@pytest.mark.parametrize("kind", ["fc", "cnn", "lstm"])
def test_seeded_models(kind):
    grids, seeds, targets = toy2d.make_seeded_grid_data(CFG, 512, seed_size=2)
    grids, seeds, targets = map(jnp.asarray, (grids, seeds, targets))
    key = jax.random.PRNGKey(3)
    if kind == "fc":
        cfg = bl.SeededConfig(n_layers=CFG.n_layers, n_tracks=CFG.n_tracks,
                              seed_size=2, hidden_dim=64)
        params = bl.init_seeded_fc(key, cfg)
        logits_fn = lambda p: bl.seeded_fc_logits(p, grids, seeds, cfg)
        steps = 400
    elif kind == "cnn":
        cfg = bl.SeededCNNConfig(n_layers=CFG.n_layers, n_tracks=CFG.n_tracks,
                                 seed_size=2, n_conv=3, n_filters=8)
        params = bl.init_seeded_cnn(key, cfg)
        logits_fn = lambda p: bl.seeded_cnn_logits(p, grids, seeds, cfg)
        steps = 120
    else:
        cfg = bl.SeededLSTMConfig(n_layers=CFG.n_layers, n_tracks=CFG.n_tracks,
                                  seed_size=2, hidden_dim=16)
        params = bl.init_seeded_lstm(key, cfg)
        logits_fn = lambda p: bl.seeded_lstm_logits(p, grids, seeds, cfg)
        steps = 150

    logits = logits_fn(params)
    assert logits.shape == targets.shape

    def loss_fn(p):
        return bl.softmax_xent(logits_fn(p), targets)

    loss0 = float(loss_fn(params))
    params, loss1 = _fit(loss_fn, params, steps=steps)
    assert loss1 < loss0
    if kind == "fc":  # cheap enough to train to high per-layer accuracy
        acc = float(bl.row_accuracy(logits_fn(params), targets))
        assert acc > 0.85, acc
