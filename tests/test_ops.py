"""Tests for sparse message-passing primitives vs dense matmul oracles."""

import jax
import jax.numpy as jnp
import numpy as np

from gnn_fpga_jax.ops import segment as ops


def _setup(rng, n_node=9, n_edge=21, f=5):
    x = rng.normal(size=(n_node, f)).astype(np.float32)
    idx = rng.integers(0, n_node, size=n_edge).astype(np.int32)
    r = np.zeros((n_node, n_edge), np.float32)
    r[idx, np.arange(n_edge)] = 1
    return x, idx, r


def test_gather_equals_dense():
    rng = np.random.default_rng(0)
    x, idx, r = _setup(rng)
    np.testing.assert_allclose(np.asarray(ops.gather(x, idx)), r.T @ x,
                               rtol=1e-6)


def test_segment_sum_equals_dense():
    rng = np.random.default_rng(1)
    x, idx, r = _setup(rng)
    msgs = rng.normal(size=(21, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(ops.segment_sum(msgs, idx, 9)), r @ msgs, rtol=1e-5, atol=1e-6)


def test_weighted_segment_sum_equals_dense():
    rng = np.random.default_rng(2)
    x, idx, r = _setup(rng)
    msgs = rng.normal(size=(21, 5)).astype(np.float32)
    w = rng.uniform(size=21).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(ops.weighted_segment_sum(msgs, w, idx, 9)),
        (r * w[None, :]) @ msgs, rtol=1e-5, atol=1e-6)


def test_segment_sum_drops_out_of_range():
    msgs = np.ones((4, 2), np.float32)
    idx = np.array([0, 1, 5, 7], np.int32)  # 5,7 out of range for n=3
    out = np.asarray(ops.segment_sum(msgs, idx, 3))
    np.testing.assert_array_equal(out, [[1, 1], [1, 1], [0, 0]])


def test_edge_concat_order_and_masking():
    """Concat order is [senders, receivers] = [bo, bi] (model.py:69-73) and
    masked edges give zero rows."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    senders = np.array([0, 2], np.int32)
    receivers = np.array([1, 4], np.int32)
    em = np.array([1.0, 0.0], np.float32)
    b = np.asarray(ops.edge_concat(x, senders, receivers, em))
    np.testing.assert_allclose(b[0], np.concatenate([x[0], x[1]]), rtol=1e-6)
    np.testing.assert_array_equal(b[1], 0)


def test_gather_grad():
    rng = np.random.default_rng(4)
    x, idx, r = _setup(rng, n_node=6, n_edge=10, f=3)
    f = lambda x: jnp.sum(ops.gather(x, idx) ** 2)
    g = np.asarray(jax.grad(f)(jnp.asarray(x)))
    # dense equivalent: d/dx sum((R^T x)^2) = 2 R R^T x
    expect = 2 * r @ (r.T @ x)
    np.testing.assert_allclose(g, expect, rtol=1e-5, atol=1e-6)


def test_segment_mean():
    msgs = np.array([[2.0], [4.0], [6.0]], np.float32)
    idx = np.array([0, 0, 1], np.int32)
    out = np.asarray(ops.segment_mean(msgs, idx, 3))
    np.testing.assert_allclose(out[:2], [[3.0], [6.0]])
    np.testing.assert_allclose(out[2], [0.0])
