"""GCN family tests: adjacency construction/normalisation, line-graph
transform correctness, and convergence on the seeded toy task
(reference: test acc 0.886 vs naive-seed 0.825, `GCN_Toy2D.ipynb:cell24`)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import gcn


def test_layer_adjacency():
    l = np.array([[0, 0, 1, 1, 2]])
    a = gcn.layer_adjacency(l)
    assert a.shape == (1, 5, 5)
    assert a[0, 0, 2] == 1 and a[0, 2, 4] == 1
    assert a[0, 0, 1] == 0 and a[0, 0, 4] == 0
    np.testing.assert_array_equal(a[0], a[0].T)


def test_row_norm_adjacency_rows_sum_to_one():
    rng = np.random.default_rng(0)
    a = (rng.uniform(size=(3, 6, 6)) > 0.5).astype(np.float32)
    an = gcn.row_norm_adjacency(a)
    sums = an.sum(axis=-1)
    nonzero = a.sum(axis=-1) > 0
    np.testing.assert_allclose(sums[nonzero], 1.0, rtol=1e-6)


def test_kipf_welling_symmetric():
    rng = np.random.default_rng(1)
    a = (rng.uniform(size=(2, 5, 5)) > 0.6).astype(np.float32)
    a = np.maximum(a, a.transpose(0, 2, 1))
    akw = gcn.kipf_welling_adjacency(a)
    np.testing.assert_allclose(akw, akw.transpose(0, 2, 1), atol=1e-6)
    # self-loops present
    assert (np.diagonal(akw, axis1=1, axis2=2) > 0).all()


def test_toy_adjacency_connects_true_tracks():
    cfg = toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=0)
    x, y, r, l = toy2d.generate_events(cfg, 4)
    adj, adj_y = gcn.toy_adjacency(x, r, l, y)
    # true adjacency is a subset of the layer adjacency and every
    # consecutive-layer same-track pair is in it
    al = gcn.layer_adjacency(l)
    assert (adj_y <= al).all()
    # entry/exit constraints keep same-track segments (tracks are straight
    # lines within [0,1) at entry/exit by construction)
    keep_frac = (adj * adj_y).sum() / adj_y.sum()
    assert keep_frac > 0.95


def test_segment_line_graph_transform():
    cfg = toy2d.Toy2DConfig(n_layers=3, n_tracks=2, seed=1)
    x, y, r, l = toy2d.generate_events(cfg, 2)
    hit_adj = gcn.layer_adjacency(l)
    seg_idx = gcn.segment_indices(hit_adj)
    # segments per event: 2 layer pairs x 2x2 = 8
    assert seg_idx.shape == (2, 8, 2)
    seg_adj = gcn.segment_adjacency(seg_idx)
    np.testing.assert_array_equal(seg_adj, seg_adj.transpose(0, 2, 1))
    # adjacency iff shared middle hit
    for e in range(2):
        for i in range(8):
            for j in range(8):
                expect = (seg_idx[e, i, 1] == seg_idx[e, j, 0]
                          or seg_idx[e, j, 1] == seg_idx[e, i, 0])
                assert seg_adj[e, i, j] == float(expect)
    seg_y = gcn.segment_labels(y, seg_idx)
    assert seg_y.shape == (2, 8)
    # exactly 2 true segments per layer pair (one per track) = 4 per event
    np.testing.assert_array_equal(seg_y.sum(axis=1), [4, 4])


def test_gaussian_kernel_peaks_on_equal_slopes():
    s = np.array([[0.1, 0.1, 0.5]])
    k = gcn.gaussian_slope_kernel(s, sigma=0.01)
    assert k[0, 0, 1] == pytest.approx(1.0)
    assert k[0, 0, 2] < 1e-6


def _fit_gcn(feats, a, y, cfg, n_steps=150, lr=5e-3, batch=64):
    params = gcn.init_gcn_classifier(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, a, y):
        def loss_fn(p):
            logits = gcn.gcn_classifier_logits(p, x, a, cfg)
            return optax.sigmoid_binary_cross_entropy(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n = feats.shape[0]
    rng = np.random.default_rng(0)
    for i in range(n_steps):
        sel = rng.integers(0, n, batch)
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(feats[sel]), jnp.asarray(a[sel]),
            jnp.asarray(y[sel]))
    return params, float(loss)


def test_gcrn_converges_on_seeded_task():
    cfg_data = toy2d.Toy2DConfig(n_layers=6, n_tracks=3, seed=0)
    feats, a, y0 = toy2d.make_gcn_data(cfg_data, 512, seed_layers=2)
    cfg = gcn.GCNConfig(input_dim=3, hidden_dims=(8, 8, 8, 8),
                        residual=True)
    params, loss = _fit_gcn(feats, a, y0, cfg)
    probs = np.asarray(gcn.gcn_classifier(params, jnp.asarray(feats),
                                          jnp.asarray(a), cfg))
    acc = ((probs > 0.5) == y0).mean()
    # naive baseline: predict seed feature itself (~ seeded layers only)
    naive = (feats[..., 2] == y0).mean()
    assert acc > 0.8, (acc, naive)
    assert acc > naive - 0.05


def test_gcn_plain_runs_and_counts_params():
    cfg = gcn.GCNConfig(input_dim=3, hidden_dims=(8, 8), gc_kind="conv",
                        residual=False)
    params = gcn.init_gcn_classifier(jax.random.PRNGKey(2), cfg)
    x = jnp.zeros((4, 10, 3))
    a = jnp.eye(10)[None].repeat(4, axis=0)
    out = gcn.gcn_classifier(params, x, a, cfg)
    assert out.shape == (4, 10)
    assert gcn.count_params(params) > 0


def test_segment_gcn_dual_graph_trains():
    cfg_data = toy2d.Toy2DConfig(n_layers=4, n_tracks=2, seed=3)
    feats, a, seg_y = toy2d.make_segment_gcn_data(cfg_data, 256)
    cfg = gcn.GCNConfig(input_dim=2, hidden_dims=(8, 8, 8), residual=True)
    params, loss = _fit_gcn(feats, a, seg_y, cfg, n_steps=200)
    probs = np.asarray(gcn.gcn_classifier(params, jnp.asarray(feats),
                                          jnp.asarray(a), cfg))
    acc = ((probs > 0.5) == seg_y).mean()
    assert acc > 0.75, acc
