"""Activation-parity tests: COO gather/segment-sum models vs the dense
incidence-matrix oracle (the reference formulation, model.py:36-156).

Per-iteration edge scores and node activations must agree to float32
tolerance — the parity gate required by BASELINE.md.
"""

import jax
import numpy as np
import pytest

from gnn_fpga_jax.core import graph as G
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.compress import pruning

from oracle import (
    segment_classifier_dense,
    segment_classifier_unshared_dense,
    node_classifier_dense,
)

TOL = dict(rtol=2e-5, atol=2e-6)


def _random_graph(rng, n_node=12, n_edge=30, n_feat=3):
    x = rng.normal(size=(n_node, n_feat)).astype(np.float32)
    senders = rng.integers(0, n_node, size=n_edge)
    receivers = rng.integers(0, n_node, size=n_edge)
    y = rng.integers(0, 2, size=n_edge).astype(np.float32)
    return G.from_coo(x, senders, receivers, y)


def test_segment_classifier_parity_per_iteration():
    rng = np.random.default_rng(0)
    g = _random_graph(rng)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=4)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), cfg)
    out, es, hs = mpnn.segment_classifier_intermediates(params, g, cfg)
    x, ri, ro, _ = G.to_dense_incidence(g)
    ref_out, ref_es, ref_hs = segment_classifier_dense(
        params, x, ri, ro, cfg.n_iters, return_intermediates=True)
    for i in range(cfg.n_iters):
        np.testing.assert_allclose(np.asarray(es[i]), ref_es[i], **TOL)
        np.testing.assert_allclose(np.asarray(hs[i + 1]), ref_hs[i + 1], **TOL)
    np.testing.assert_allclose(np.asarray(out), ref_out, **TOL)


def test_segment_classifier_parity_padded():
    """Padding must not change real-edge outputs vs the unpadded graph."""
    rng = np.random.default_rng(1)
    g = _random_graph(rng, n_node=9, n_edge=17)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=3)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(2), cfg)
    out = np.asarray(mpnn.segment_classifier(params, g, cfg))
    gp = G.pad_graph(g, 16, 32)
    outp = np.asarray(mpnn.segment_classifier(params, gp, cfg))
    np.testing.assert_allclose(outp[:17], out, **TOL)
    # padded graph also matches the dense oracle on the padded shapes
    x, ri, ro, _ = G.to_dense_incidence(gp)
    ref = segment_classifier_dense(params, x, ri, ro, cfg.n_iters)
    np.testing.assert_allclose(outp, ref, **TOL)


def test_segment_classifier_scan_matches_unrolled():
    rng = np.random.default_rng(2)
    g = _random_graph(rng)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=5)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(3), cfg)
    scan_logits = np.asarray(mpnn.segment_classifier_logits(params, g, cfg))
    out, _, _ = mpnn.segment_classifier_intermediates(params, g, cfg)
    np.testing.assert_allclose(
        jax.nn.sigmoid(scan_logits), np.asarray(out), **TOL)


def test_segment_classifier_vmap_batched():
    rng = np.random.default_rng(3)
    gs = [_random_graph(rng, n_node=8, n_edge=14) for _ in range(3)]
    batch = G.batch_graphs(gs, 10, 16)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=2)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(4), cfg)
    vout = np.asarray(jax.vmap(
        lambda g: mpnn.segment_classifier(params, g, cfg))(batch))
    for i, g in enumerate(gs):
        single = np.asarray(mpnn.segment_classifier(params, g, cfg))
        np.testing.assert_allclose(vout[i, :14], single, **TOL)


def test_masked_parity():
    """Masked forward == dense oracle with the same masks (model_maskedlinear)."""
    rng = np.random.default_rng(4)
    g = _random_graph(rng)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=3)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(5), cfg)
    masked_params, masks = pruning.prune_round(params, threshold=0.05)
    out = np.asarray(mpnn.segment_classifier(masked_params, g, cfg, masks))
    x, ri, ro, _ = G.to_dense_incidence(g)
    np_masks = {m: {k: np.asarray(v) for k, v in lm.items()}
                for m, lm in masks.items()}
    ref = segment_classifier_dense(masked_params, x, ri, ro, cfg.n_iters,
                                   masks=np_masks)
    np.testing.assert_allclose(out, ref, **TOL)
    assert pruning.sparsity(masks) > 0


def test_unshared_parity():
    rng = np.random.default_rng(5)
    g = _random_graph(rng, n_feat=2)
    cfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=3)
    params = mpnn.init_segment_classifier_unshared(jax.random.PRNGKey(6), cfg)
    out = np.asarray(mpnn.segment_classifier_unshared(params, g, cfg))
    x, ri, ro, _ = G.to_dense_incidence(g)
    ref = segment_classifier_unshared_dense(params, x, ri, ro, cfg.n_iters)
    np.testing.assert_allclose(out, ref, **TOL)


def test_node_classifier_parity():
    rng = np.random.default_rng(6)
    g = _random_graph(rng, n_feat=4)
    cfg = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=2)
    params = mpnn.init_node_classifier(jax.random.PRNGKey(7), cfg)
    out = np.asarray(mpnn.node_classifier(params, g, cfg))
    x, ri, ro, _ = G.to_dense_incidence(g)
    ref = node_classifier_dense(params, x, ri, ro, cfg.n_iters)
    np.testing.assert_allclose(out, ref, **TOL)


def test_param_counts_match_reference():
    """Parameter counts must match the reference's logged values:
    189 (h=4, in=3), 6881 (h=32, in=3) — Inference.ipynb:cell2,
    MPNN_Seg_ACTS.ipynb:cell20."""
    for hidden, expect in [(4, 189), (32, 6881)]:
        cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=hidden)
        params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), cfg)
        assert mpnn.count_params(params) == expect


def test_bf16_compute_close_to_f32():
    """Mixed-precision forward stays close to the f32 forward (bf16 has
    ~3 decimal digits; the small nets keep the drift tiny)."""
    import jax.numpy as jnp
    from gnn_fpga_jax.data import toy2d

    g = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda a: a[0], toy2d.make_segment_graphs(
            toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=0), 1)))
    cfg32 = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=3)
    cfg16 = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=16, n_iters=3,
                                         compute_dtype=jnp.bfloat16)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), cfg32)
    p32 = np.asarray(mpnn.segment_classifier(params, g, cfg32))
    out16 = mpnn.segment_classifier_logits(params, g, cfg16)
    assert out16.dtype == jnp.float32  # logits return in f32
    p16 = np.asarray(jax.nn.sigmoid(out16))
    assert np.abs(p32 - p16).max() < 0.05
    # scores stay well-correlated (AUC-preserving)
    assert np.corrcoef(p32, p16)[0, 1] > 0.99
