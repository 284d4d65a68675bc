"""Tests for profiling/observability utilities."""

import numpy as np
import pytest

from gnn_fpga_jax.utils import profiling


def test_step_timer_throughput():
    timer = profiling.StepTimer(warmup=1)
    for _ in range(4):
        with timer.step(n_edges=1000):
            pass
    s = timer.summary()
    assert s["steps"] == 3
    assert s["edges_per_s"] > 0


def test_nan_check_raises():
    good = {"a": np.ones(3), "b": {"c": np.zeros(2)}}
    profiling.nan_check(good)
    bad = {"a": np.array([1.0, np.nan])}
    with pytest.raises(FloatingPointError, match="non-finite"):
        profiling.nan_check(bad, "params")


def test_nan_check_ignores_ints():
    profiling.nan_check({"idx": np.array([1, 2, 3])})


def test_params_npz_roundtrip(tmp_path):
    """Nested dicts, stacked per-iteration params, and hostile key names all
    round-trip exactly (the keystr format broke on [ and quoted keys)."""
    from gnn_fpga_jax.utils import serialization as ser

    params = {
        "input": {"w": np.arange(6.0).reshape(2, 3), "b": np.zeros(3)},
        "edge_stack": {"l1": {"w": np.ones((4, 2, 3)), "b": np.zeros((4, 3))}},
        "weird['key]": {"w": np.full((1, 1), 7.0)},
        "list_of_layers": [{"w": np.eye(2)}, {"w": 2 * np.eye(2)}],
    }
    path = tmp_path / "model.npz"
    ser.save_params_npz(path, params)
    loaded = ser.load_params_npz(path)
    import jax
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_params_npz_legacy_keystr(tmp_path):
    """Round-1 keystr-format artifacts still load."""
    from gnn_fpga_jax.utils import serialization as ser

    path = tmp_path / "old.npz"
    np.savez(path, **{"['edge']['l1']['w']": np.ones((2, 2)),
                      "['edge']['l1']['b']": np.zeros(2)})
    loaded = ser.load_params_npz(path)
    np.testing.assert_array_equal(loaded["edge"]["l1"]["w"], np.ones((2, 2)))


def test_roc_auc_ties_vectorised_matches_naive():
    from gnn_fpga_jax.train.metrics import roc_auc

    rng = np.random.default_rng(0)
    # heavy ties: quantised predictions
    pred = np.round(rng.uniform(size=5000), 2)
    target = (rng.uniform(size=5000) < 0.3).astype(np.float64)
    got = roc_auc(pred, target)
    # naive O(n_pos*n_neg) oracle on a subsample
    sub = slice(0, 400)
    p, t = pred[sub], target[sub] > 0.5
    pos, neg = p[t], p[~t]
    wins = (pos[:, None] > neg[None, :]).sum() + \
        0.5 * (pos[:, None] == neg[None, :]).sum()
    oracle = wins / (len(pos) * len(neg))
    assert abs(roc_auc(p, target[sub]) - oracle) < 1e-12
    assert 0.0 <= got <= 1.0


def test_prefetch_iterator_order_and_backpressure():
    """PrefetchIterator yields device-resident batches in order, respects
    n_batches, and surfaces source exceptions."""
    import jax
    import jax.numpy as jnp
    from gnn_fpga_jax.core.prefetch import prefetch_to_device

    def gen():
        for i in range(10):
            yield {"a": np.full((4,), i, np.float32)}

    out = list(prefetch_to_device(gen(), size=2, n_batches=5))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["a"], jax.Array)
        np.testing.assert_array_equal(np.asarray(b["a"]), i)

    def bad():
        yield {"a": np.zeros(2, np.float32)}
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), size=1)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        # the failure may land on either of the next pulls
        next(it)
        next(it)


def test_prefetch_close_stops_worker():
    import itertools
    from gnn_fpga_jax.core.prefetch import prefetch_to_device

    def infinite():
        for i in itertools.count():
            yield np.full((2,), i, np.float32)

    it = prefetch_to_device(infinite(), size=2)
    next(it)
    it.close()
    assert not it._thread.is_alive()
