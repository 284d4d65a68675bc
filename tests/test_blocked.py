"""Blocked (layered) aggregation parity: ops/blocked.py path vs the COO
sparse path on the same (edge-permuted) graph.

Layered graphs are the reference's universal structure — every builder
emits edges from layer l to l+1 (`/root/reference/gnn/graph.py:68-93`).
The blocked path must be bit-for-tolerance identical to the sparse
formulation on those graphs, including padded edges, grouped blocks,
ragged per-layer node counts, batches, and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnn_fpga_jax.core import graph as G
from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.ops import blocked

TOL = dict(rtol=2e-5, atol=2e-6)


def _layered_graph(rng, nodes_per_layer, k=3, n_feat=3):
    """Random layered graph with ragged per-layer node counts: each node
    on layer l+1 draws k random senders from layer l."""
    offsets = np.concatenate([[0], np.cumsum(nodes_per_layer)])
    n_node = int(offsets[-1])
    senders, receivers = [], []
    for l in range(len(nodes_per_layer) - 1):
        for r in range(offsets[l + 1], offsets[l + 2]):
            kk = min(k, nodes_per_layer[l])
            s = rng.choice(np.arange(offsets[l], offsets[l + 1]), size=kk,
                           replace=False)
            senders.append(s)
            receivers.append(np.full(kk, r))
    senders = np.concatenate(senders)
    receivers = np.concatenate(receivers)
    x = rng.normal(size=(n_node, n_feat)).astype(np.float32)
    y = rng.integers(0, 2, size=len(senders)).astype(np.float32)
    return G.from_coo(x, senders, receivers, y), offsets


def _sparse_logits(params, g, cfg, unshared=False):
    scfg = mpnn.SegmentClassifierConfig(
        input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim,
        n_iters=cfg.n_iters, aggregation="sparse")
    fn = (mpnn.segment_classifier_unshared_logits if unshared
          else mpnn.segment_classifier_logits)
    return np.asarray(fn(params, g.replace(blocks=None), scfg))


@pytest.mark.parametrize("group", [1, 2, 3])
def test_blocked_parity_ragged_layers(group):
    rng = np.random.default_rng(0)
    g, off = _layered_graph(rng, [5, 9, 4, 7, 6], k=3)
    gb = blocked.attach_blocks_layered(g, off, group=group)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=3,
                                       aggregation="blocked")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), cfg)
    out = np.asarray(mpnn.segment_classifier_logits(params, gb, cfg))
    ref = _sparse_logits(params, gb, cfg)
    m = np.asarray(gb.edge_mask) > 0
    np.testing.assert_allclose(out[m], ref[m], **TOL)
    # every real edge survived the permutation exactly once
    assert int(m.sum()) == g.n_edge


def test_blocked_parity_padded_graph():
    """Blocks built on an already-padded graph (pad edges masked)."""
    rng = np.random.default_rng(1)
    g, off = _layered_graph(rng, [4, 6, 5], k=2)
    gp = G.pad_graph(g, 24, 40)
    off_p = np.concatenate([off[:-1], [24]])  # pad nodes join the top layer
    gb = blocked.attach_blocks_layered(gp, off_p)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=2,
                                       aggregation="blocked")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(2), cfg)
    out = np.asarray(mpnn.segment_classifier_logits(params, gb, cfg))
    ref = _sparse_logits(params, gb, cfg)
    m = np.asarray(gb.edge_mask) > 0
    np.testing.assert_allclose(out[m], ref[m], **TOL)
    assert int(m.sum()) == g.n_edge


def test_blocked_parity_batched_toy_knn():
    """Batched kNN toy graphs (the bench config's structure) via vmap."""
    cfg2d = toy2d.Toy2DConfig(n_layers=6, n_tracks=5, seed=3)
    g = toy2d.make_knn_segment_graphs(cfg2d, n_events=4, k=3)
    off = np.arange(0, (cfg2d.n_layers + 1) * cfg2d.n_tracks,
                    cfg2d.n_tracks)
    gb = blocked.attach_blocks_layered(g, off, group=2)
    cfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=3,
                                       aggregation="blocked")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(3), cfg)
    out = np.asarray(jax.vmap(
        lambda gg: mpnn.segment_classifier_logits(params, gg, cfg))(
            jax.tree.map(jnp.asarray, gb)))
    scfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8, n_iters=3,
                                        aggregation="sparse")
    ref = np.asarray(jax.vmap(
        lambda gg: mpnn.segment_classifier_logits(params, gg, scfg))(
            jax.tree.map(jnp.asarray, gb.replace(blocks=None))))
    np.testing.assert_allclose(out, ref, **TOL)
    # labels were permuted consistently with the edge arrays
    ev = np.arange(4)[:, None]
    sy = np.asarray(g.y).sum()
    assert np.asarray(gb.y).sum() == sy


def test_blocked_parity_unshared_and_auto():
    rng = np.random.default_rng(4)
    g, off = _layered_graph(rng, [6, 6, 6, 6], k=3)
    gb = blocked.attach_blocks_layered(g, off)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=2,
                                       aggregation="auto")  # auto -> blocked
    params = mpnn.init_segment_classifier_unshared(jax.random.PRNGKey(4), cfg)
    out = np.asarray(mpnn.segment_classifier_unshared_logits(params, gb, cfg))
    ref = _sparse_logits(params, gb, cfg, unshared=True)
    m = np.asarray(gb.edge_mask) > 0
    np.testing.assert_allclose(out[m], ref[m], **TOL)


def test_blocked_gradient_parity():
    rng = np.random.default_rng(5)
    g, off = _layered_graph(rng, [5, 7, 6], k=3)
    gb = blocked.attach_blocks_layered(g, off)
    cfg_b = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8,
                                         n_iters=2, aggregation="blocked")
    cfg_s = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8,
                                         n_iters=2, aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(5), cfg_b)
    gbj = jax.tree.map(jnp.asarray, gb)
    gsj = jax.tree.map(jnp.asarray, gb.replace(blocks=None))

    def loss(p, gg, cfg):
        logits = mpnn.segment_classifier_logits(p, gg, cfg)
        em = gg.edge_mask
        return jnp.sum(jnp.where(em > 0, (logits - gg.y) ** 2, 0.0)) / em.sum()

    gb_grad = jax.grad(loss)(params, gbj, cfg_b)
    gs_grad = jax.grad(loss)(params, gsj, cfg_s)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-5, atol=5e-6),
        gb_grad, gs_grad)


def test_blocked_requires_plan():
    rng = np.random.default_rng(6)
    g, _ = _layered_graph(rng, [4, 4, 4], k=2)
    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=1,
                                       aggregation="blocked")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(6), cfg)
    with pytest.raises(ValueError, match="blocked"):
        mpnn.segment_classifier_logits(params, g, cfg)


def test_blocked_rejects_non_layered():
    rng = np.random.default_rng(7)
    g, off = _layered_graph(rng, [4, 4, 4], k=2)
    bad = g.replace(receivers=np.asarray(g.senders))  # layer l -> layer l
    with pytest.raises(ValueError, match="layered"):
        blocked.attach_blocks_layered(bad, off)


def test_node_classifier_blocked_parity():
    """NodeClassifier routes through the blocked path (hit-classifier
    candidate graphs are layered too, `MPNN_HitClassifier.ipynb:cell12`)
    and must reproduce the sparse path's node logits and gradients."""
    rng = np.random.default_rng(8)
    g, off = _layered_graph(rng, [5, 8, 6, 7], k=3, n_feat=4)
    g = g.replace(node_y=rng.integers(0, 2, size=g.n_node).astype(np.float32))
    gb = blocked.attach_blocks_layered(g, off, group=2)
    cfg_b = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=3,
                                      aggregation="blocked")
    cfg_s = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=3,
                                      aggregation="sparse")
    params = mpnn.init_node_classifier(jax.random.PRNGKey(8), cfg_b)
    out = np.asarray(mpnn.node_classifier_logits(params, gb, cfg_b))
    ref = np.asarray(mpnn.node_classifier_logits(
        params, gb.replace(blocks=None), cfg_s))
    np.testing.assert_allclose(out, ref, **TOL)

    # auto-routing picks blocked when blocks are attached
    cfg_a = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=3,
                                      aggregation="auto")
    out_auto = np.asarray(mpnn.node_classifier_logits(params, gb, cfg_a))
    np.testing.assert_allclose(out_auto, out, rtol=0, atol=0)

    def loss(p, gg, cfg):
        logits = mpnn.node_classifier_logits(p, gg, cfg)
        return jnp.mean((logits - gg.node_y) ** 2)

    gb_grad = jax.grad(loss)(params, jax.tree.map(jnp.asarray, gb), cfg_b)
    gs_grad = jax.grad(loss)(
        params, jax.tree.map(jnp.asarray, gb.replace(blocks=None)), cfg_s)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-5, atol=5e-6),
        gb_grad, gs_grad)
