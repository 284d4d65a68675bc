"""Tests for core graph structures: COO <-> dense, padding, batching, NPZ IO."""

import numpy as np
import pytest

from gnn_fpga_jax.core import graph as G
from gnn_fpga_jax.core import batching


def _random_graph(rng, n_node=7, n_edge=11, n_feat=3, node_y=False):
    x = rng.normal(size=(n_node, n_feat)).astype(np.float32)
    senders = rng.integers(0, n_node, size=n_edge)
    receivers = rng.integers(0, n_node, size=n_edge)
    y = rng.integers(0, 2, size=n_edge).astype(np.float32)
    ny = rng.integers(0, 2, size=n_node).astype(np.float32) if node_y else None
    return G.from_coo(x, senders, receivers, y, node_y=ny)


def test_dense_roundtrip():
    rng = np.random.default_rng(0)
    g = _random_graph(rng)
    x, ri, ro, y = G.to_dense_incidence(g)
    assert ri.shape == (7, 11) and ro.shape == (7, 11)
    # each real edge contributes exactly one 1 per matrix
    np.testing.assert_array_equal(ri.sum(axis=0), np.ones(11))
    g2 = G.from_dense_incidence(x, ri, ro, y)
    np.testing.assert_array_equal(np.asarray(g2.senders), np.asarray(g.senders))
    np.testing.assert_array_equal(np.asarray(g2.receivers), np.asarray(g.receivers))
    np.testing.assert_allclose(np.asarray(g2.x), np.asarray(g.x))


def test_pad_graph_masks_and_pad_node():
    rng = np.random.default_rng(1)
    g = _random_graph(rng, n_node=5, n_edge=6)
    p = G.pad_graph(g, 8, 10)
    assert p.x.shape == (8, 3) and p.senders.shape == (10,)
    np.testing.assert_array_equal(np.asarray(p.node_mask), [1] * 5 + [0] * 3)
    np.testing.assert_array_equal(np.asarray(p.edge_mask), [1] * 6 + [0] * 4)
    # padded edges point at the FIRST (zero-feature) pad-node slot
    assert all(np.asarray(p.senders)[6:] == 5)
    np.testing.assert_array_equal(np.asarray(p.x)[5:], 0)
    # padded dense incidence has zero columns for pad edges
    _, ri, ro, _ = G.to_dense_incidence(p)
    np.testing.assert_array_equal(ri[:, 6:], 0)
    np.testing.assert_array_equal(ro[:, 6:], 0)


def test_pad_graph_too_small_raises():
    rng = np.random.default_rng(2)
    g = _random_graph(rng, n_node=5, n_edge=6)
    with pytest.raises(ValueError):
        G.pad_graph(g, 4, 10)


def test_batch_graphs_shapes():
    rng = np.random.default_rng(3)
    gs = [_random_graph(rng, n_node=4 + i, n_edge=5 + 2 * i) for i in range(4)]
    b = G.batch_graphs(gs)
    assert b.x.shape[0] == 4
    assert b.x.shape[1] == 7 + 1  # max nodes + pad node
    assert b.senders.shape[1] == 11


def test_pack_graphs_offsets():
    rng = np.random.default_rng(4)
    gs = [_random_graph(rng, n_node=4, n_edge=5) for _ in range(3)]
    p = G.pack_graphs(gs)
    assert p.x.shape == (12, 3)
    assert p.senders.shape == (15,)
    # second graph's edges offset by 4
    np.testing.assert_array_equal(
        np.asarray(p.senders)[5:10], np.asarray(gs[1].senders) + 4)


def test_npz_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    g = _random_graph(rng)
    fn = tmp_path / "graph000.npz"
    G.save_npz(g, fn)
    g2 = G.load_npz(fn)
    np.testing.assert_allclose(np.asarray(g2.x), np.asarray(g.x))
    np.testing.assert_array_equal(np.asarray(g2.senders), np.asarray(g.senders))
    np.testing.assert_array_equal(np.asarray(g2.receivers), np.asarray(g.receivers))
    np.testing.assert_array_equal(np.asarray(g2.y), np.asarray(g.y))


def test_npz_reference_format(tmp_path):
    """File must carry the reference SparseGraph keys (graph.py:20-26)."""
    rng = np.random.default_rng(6)
    g = _random_graph(rng)
    fn = tmp_path / "g.npz"
    G.save_npz(g, fn, pt=np.float32(21.5), eta=np.float32(1.3))
    with np.load(fn) as f:
        assert set(f.files) >= {"X", "Ri_rows", "Ri_cols", "Ro_rows", "Ro_cols", "y"}
    g2, extras = G.load_npz_with_extras(fn)
    assert float(extras["pt"]) == 21.5


def test_npz_skips_padding(tmp_path):
    rng = np.random.default_rng(7)
    g = G.pad_graph(_random_graph(rng, n_node=5, n_edge=6), 9, 12)
    fn = tmp_path / "g.npz"
    G.save_npz(g, fn)
    g2 = G.load_npz(fn)
    assert g2.x.shape == (5, 3) and g2.senders.shape == (6,)


def test_choose_bucket_multiples():
    rng = np.random.default_rng(8)
    gs = [_random_graph(rng, n_node=30 + i, n_edge=100 + i) for i in range(5)]
    spec = batching.choose_bucket(gs)
    assert spec.n_node % 8 == 0 and spec.n_edge % 128 == 0
    assert spec.n_node >= 35 and spec.n_edge >= 104


def test_batch_generator_static_shapes():
    rng = np.random.default_rng(9)
    gs = [_random_graph(rng, n_node=rng.integers(4, 12),
                        n_edge=rng.integers(5, 20)) for _ in range(10)]
    spec = batching.choose_bucket(gs)
    gen = batching.batch_generator(gs, batch_size=3, bucket=spec, seed=0)
    shapes = {next(gen).x.shape for _ in range(7)}
    assert len(shapes) == 1  # static across batches/epochs


def test_batch_generator_packed():
    rng = np.random.default_rng(10)
    gs = [_random_graph(rng, n_node=6, n_edge=9) for _ in range(4)]
    spec = batching.choose_bucket(gs)
    gen = batching.batch_generator(gs, batch_size=2, bucket=spec, packed=True)
    b = next(gen)
    assert b.x.ndim == 2
    assert b.x.shape[0] == spec.n_node * 2
    assert b.senders.shape[0] == spec.n_edge * 2


def test_unbatch_roundtrip():
    """batch_graphs -> unbatch_graphs round-trips, and batch_generator
    accepts a batched Graph directly (toy-generator output)."""
    from gnn_fpga_jax.core import batching
    from gnn_fpga_jax.data import toy2d
    g = toy2d.make_segment_graphs(toy2d.Toy2DConfig(n_layers=4, n_tracks=3), 8)
    singles = G.unbatch_graphs(g)
    assert len(singles) == 8
    np.testing.assert_array_equal(np.asarray(singles[3].x), np.asarray(g.x)[3])
    gen = batching.batch_generator(g, batch_size=4, seed=0)
    b = next(gen)
    assert np.asarray(b.x).ndim == 3 and np.asarray(b.x).shape[0] == 4


def test_toy2d_radius_feature_normalized():
    """Radius feature must be scaled to [0,1] (feature_scale semantics,
    prepareGraphs.py:149-150) so the tanh input layer doesn't saturate."""
    from gnn_fpga_jax.data import toy2d
    g = toy2d.make_segment_graphs(toy2d.Toy2DConfig(n_layers=12, n_tracks=2), 4)
    assert float(np.asarray(g.x)[..., 1].max()) <= 1.0


def test_npz_node_labels_roundtrip(tmp_path):
    """Node-labelled (hit-classifier) graphs persist node_y through NPZ
    (`MPNN_HitClassifier.ipynb` dataset pipeline)."""
    rng = np.random.default_rng(12)
    g = _random_graph(rng, node_y=True)
    p = tmp_path / "g.npz"
    G.save_npz(g, p)
    g2 = G.load_npz(p)
    np.testing.assert_allclose(np.asarray(g2.node_y), np.asarray(g.node_y))
    # extras loader must not report node_y as an extra key
    _, extras = G.load_npz_with_extras(p)
    assert "node_y" not in extras


def test_multibucket_generator_covers_and_saves_padding():
    """Bimodal size mix: two buckets cut padding waste vs one, and the
    generator still yields every graph each epoch (VERDICT r1 item 7)."""
    rng = np.random.default_rng(13)
    small = [_random_graph(rng, n_node=8, n_edge=12) for _ in range(8)]
    large = [_random_graph(rng, n_node=60, n_edge=600) for _ in range(8)]
    gs = small + large
    one = batching.choose_bucket(gs)
    two = batching.choose_buckets(gs, 2)
    assert len(two) == 2
    eff1 = batching.padding_efficiency(gs, one, batch_size=4)
    eff2 = batching.padding_efficiency(gs, two, batch_size=4)
    assert eff2 > 1.5 * eff1  # small graphs no longer padded to 640 edges
    gen = batching.batch_generator(gs, batch_size=4, bucket=two, seed=0)
    shapes = set()
    seen_edges = 0
    for _ in range(4):  # one epoch = 16 graphs / 4
        b = next(gen)
        shapes.add((b.n_node, b.n_edge))
        seen_edges += int(np.asarray(b.edge_mask).sum())
    assert len(shapes) == 2  # both buckets exercised
    assert seen_edges == sum(int(np.asarray(g.edge_mask).sum()) for g in gs)


def test_multibucket_small_pool_merges_upward():
    """A bucket with fewer graphs than batch_size folds into the next."""
    rng = np.random.default_rng(14)
    gs = ([_random_graph(rng, n_node=8, n_edge=12) for _ in range(2)]
          + [_random_graph(rng, n_node=40, n_edge=300) for _ in range(6)])
    specs = batching.choose_buckets(gs, 2)
    gen = batching.batch_generator(gs, batch_size=4, bucket=specs, seed=0)
    seen = 0
    for _ in range(2):
        b = next(gen)
        seen += int(np.asarray(b.edge_mask).sum())
    assert seen == sum(int(np.asarray(g.edge_mask).sum()) for g in gs)


def test_bucket_merge_expands_spec_to_dominate():
    """Merging an under-filled pool upward must expand the destination spec
    on BOTH dims (ADVICE r2): many-node/few-edge graphs merged into a
    few-node/many-edge bucket previously raised mid-epoch."""
    rng = np.random.default_rng(15)
    gs = ([_random_graph(rng, n_node=100, n_edge=10) for _ in range(6)]
          + [_random_graph(rng, n_node=20, n_edge=500) for _ in range(6)])
    specs = batching.choose_buckets(gs, 2)
    gen = batching.batch_generator(gs, batch_size=8, bucket=specs, seed=0)
    b = next(gen)  # raised ValueError before the fix
    assert b.n_node >= 101 and b.n_edge >= 500


def test_bucket_trailing_undersized_pool_warns():
    """Graphs that can never form a batch are dropped loudly, not silently
    (ADVICE r2)."""
    import warnings
    rng = np.random.default_rng(16)
    gs = ([_random_graph(rng, n_node=8, n_edge=12) for _ in range(8)]
          + [_random_graph(rng, n_node=60, n_edge=600) for _ in range(2)])
    specs = batching.choose_buckets(gs, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        gen = batching.batch_generator(gs, batch_size=4, bucket=specs, seed=0)
        next(gen)
    assert any("excluded from every epoch" in str(x.message) for x in w)


def test_layer_offsets_from_layers():
    """NPZ per-node layer arrays -> blocked-path offsets (the train
    CLI's loading path for --aggregation blocked)."""
    layers = np.array([0, 0, 0, 1, 1, 3, 3, 3])   # layer 2 empty
    off = G.layer_offsets_from_layers(layers)
    np.testing.assert_array_equal(off, [0, 3, 5, 5, 8])
    # pinned n_layers extends the table with empty top layers
    off6 = G.layer_offsets_from_layers(layers, n_layers=6)
    np.testing.assert_array_equal(off6, [0, 3, 5, 5, 8, 8, 8])
    with np.testing.assert_raises(ValueError):
        G.layer_offsets_from_layers(np.array([1, 0, 2]))  # unsorted
    with np.testing.assert_raises(ValueError):
        G.layer_offsets_from_layers(layers[None])         # not 1-D
