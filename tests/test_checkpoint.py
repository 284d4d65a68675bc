"""NPZ checkpoints: optax state round trips into the template's tree,
best-model retention keeps the best validation state, and a mismatched
template is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gnn_fpga_jax.train.checkpoint import CheckpointManager


def _state(seed=0):
    params = {"edge": {"l1": {"w": jnp.ones((3, 2)) * seed,
                              "b": jnp.arange(2.0)}},
              "stack": [jnp.full((2,), 1.0 + seed), jnp.zeros((1, 1))]}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    grads = jax.tree.map(lambda a: a + 0.5, params)
    _, opt_state = opt.update(grads, opt_state, params)
    return {"params": params, "opt_state": opt_state}


def _assert_same(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_round_trip_with_optax_state(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = _state(seed=3)
    meta = {"epoch": 2, "train_losses": [0.7, 0.5]}
    ckpt.save(state, meta)
    arrays, got_meta = ckpt.restore(_state(seed=0))
    _assert_same(arrays, jax.tree.map(np.asarray, state))
    assert got_meta == meta
    # the adam step count (int32) survives with its dtype
    assert int(arrays["opt_state"][0].count) == 1


def test_best_is_kept_when_latest_moves_on(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    best = _state(seed=1)
    ckpt.save(best, {"epoch": 1}, is_best=True)
    ckpt.save(_state(seed=2), {"epoch": 2}, is_best=False)
    got_best, meta_best = ckpt.restore(_state(), best=True)
    got_latest, meta_latest = ckpt.restore(_state(), best=False)
    _assert_same(got_best, jax.tree.map(np.asarray, best))
    assert meta_best["epoch"] == 1 and meta_latest["epoch"] == 2
    assert float(got_latest["params"]["stack"][0][0]) == 3.0


def test_missing_checkpoint_and_mismatched_template(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.restore(_state()) is None and not ckpt.exists()
    ckpt.save(_state(), {"epoch": 1})
    wrong = _state()
    wrong["params"]["edge"]["l1"]["w"] = jnp.ones((4, 2))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(wrong)
    del wrong["params"]["stack"]
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore(wrong)
