"""Dense-incidence (one-hot bmm) vs COO sparse aggregation.

The two layouts must be numerically equivalent in f32 (same sums, modulo
summation order): ops-level and full-model, padded, masked, and vmapped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnn_fpga_jax.core import graph as G
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.ops import dense_incidence as dinc
from gnn_fpga_jax.ops import segment as ops
from gnn_fpga_jax.compress import pruning

TOL = dict(rtol=2e-5, atol=2e-6)


def _random_graph(rng, n_node=12, n_edge=30, n_feat=3):
    x = rng.normal(size=(n_node, n_feat)).astype(np.float32)
    senders = rng.integers(0, n_node, size=n_edge)
    receivers = rng.integers(0, n_node, size=n_edge)
    y = rng.integers(0, 2, size=n_edge).astype(np.float32)
    return G.from_coo(x, senders, receivers, y)


def test_incidence_ops_match_sparse_ops():
    rng = np.random.default_rng(0)
    g = _random_graph(rng, n_node=20, n_edge=50, n_feat=8)
    h = jnp.asarray(rng.normal(size=(20, 8)).astype(np.float32))
    e = jnp.asarray(rng.uniform(size=(50,)).astype(np.float32))
    ro = dinc.incidence(g.senders, 20, g.edge_mask, jnp.float32)
    ri = dinc.incidence(g.receivers, 20, g.edge_mask, jnp.float32)
    # gather
    bo = dinc.gather_bmm(ro, h)
    ref_bo = ops.gather(h, g.senders) * g.edge_mask[:, None]
    np.testing.assert_allclose(np.asarray(bo), np.asarray(ref_bo), **TOL)
    # weighted scatter
    mi = dinc.scatter_bmm(ri, bo, e)
    ref_mi = ops.weighted_segment_sum(ref_bo, e, g.receivers, 20)
    np.testing.assert_allclose(np.asarray(mi), np.asarray(ref_mi), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_model_dense_matches_sparse(masked):
    rng = np.random.default_rng(1)
    g = _random_graph(rng, n_node=15, n_edge=40)
    cfg_s = mpnn.SegmentClassifierConfig(
        input_dim=3, hidden_dim=8, n_iters=4, aggregation="sparse")
    cfg_d = dataclasses.replace(cfg_s, aggregation="dense")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), cfg_s)
    masks = pruning.magnitude_masks(params, 0.05) if masked else None
    ls = mpnn.segment_classifier_logits(params, g, cfg_s, masks)
    ld = mpnn.segment_classifier_logits(params, g, cfg_d, masks)
    np.testing.assert_allclose(np.asarray(ls), np.asarray(ld), **TOL)


def test_model_dense_matches_sparse_padded_vmapped():
    rng = np.random.default_rng(2)
    gs = [_random_graph(rng, n_node=int(n), n_edge=int(e))
          for n, e in [(9, 17), (12, 25), (7, 11)]]
    batch = G.batch_graphs(gs, n_node=16, n_edge=32)
    cfg_s = mpnn.SegmentClassifierConfig(
        input_dim=3, hidden_dim=8, n_iters=3, aggregation="sparse")
    cfg_d = dataclasses.replace(cfg_s, aggregation="dense")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(3), cfg_s)
    ls = jax.vmap(lambda g: mpnn.segment_classifier_logits(params, g, cfg_s))(batch)
    ld = jax.vmap(lambda g: mpnn.segment_classifier_logits(params, g, cfg_d))(batch)
    np.testing.assert_allclose(np.asarray(ls), np.asarray(ld), **TOL)


def test_auto_heuristic():
    rng = np.random.default_rng(3)
    small = _random_graph(rng, n_node=10, n_edge=20)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8)
    assert mpnn._use_dense(cfg, small)
    big = G.from_coo(
        np.zeros((4000, 3), np.float32),
        np.zeros(30000, np.int64), np.zeros(30000, np.int64),
        np.zeros(30000, np.float32))
    assert not mpnn._use_dense(cfg, big)
    assert mpnn._use_dense(dataclasses.replace(cfg, aggregation="dense"), big)
    assert not mpnn._use_dense(dataclasses.replace(cfg, aggregation="sparse"), small)


def test_dense_bf16_close_to_f32():
    rng = np.random.default_rng(4)
    g = _random_graph(rng, n_node=15, n_edge=40)
    cfg = mpnn.SegmentClassifierConfig(
        input_dim=3, hidden_dim=8, n_iters=3, aggregation="dense")
    cfg_bf = dataclasses.replace(cfg, compute_dtype=jnp.bfloat16)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(5), cfg)
    lf = mpnn.segment_classifier_logits(params, g, cfg)
    lb = mpnn.segment_classifier_logits(params, g, cfg_bf)
    assert lb.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(lf), np.asarray(lb), rtol=0.1, atol=0.1)


def test_unshared_dense_matches_sparse():
    rng = np.random.default_rng(5)
    g = _random_graph(rng, n_node=15, n_edge=40)
    cfg_s = mpnn.SegmentClassifierConfig(
        input_dim=3, hidden_dim=8, n_iters=3, aggregation="sparse")
    cfg_d = dataclasses.replace(cfg_s, aggregation="dense")
    params = mpnn.init_segment_classifier_unshared(jax.random.PRNGKey(7), cfg_s)
    ls = mpnn.segment_classifier_unshared_logits(params, g, cfg_s)
    ld = mpnn.segment_classifier_unshared_logits(params, g, cfg_d)
    np.testing.assert_allclose(np.asarray(ls), np.asarray(ld), **TOL)


def test_node_classifier_dense_matches_sparse():
    rng = np.random.default_rng(6)
    g = _random_graph(rng, n_node=15, n_edge=40, n_feat=4)
    cfg_s = mpnn.NodeClassifierConfig(
        input_dim=4, hidden_dim=8, n_iters=3, aggregation="sparse")
    cfg_d = dataclasses.replace(cfg_s, aggregation="dense")
    params = mpnn.init_node_classifier(jax.random.PRNGKey(8), cfg_s)
    ls = mpnn.node_classifier_logits(params, g, cfg_s)
    ld = mpnn.node_classifier_logits(params, g, cfg_d)
    np.testing.assert_allclose(np.asarray(ls), np.asarray(ld), **TOL)
