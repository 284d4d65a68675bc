"""Unified Trainer over execution strategies (single / dp / partitioned)
on the virtual 8-device CPU mesh — VERDICT r1 item 6: one engine with
fit/checkpoint/metrics/eval for all three modes, mixed precision working
in the sharded forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.parallel import mesh as mesh_lib
from gnn_fpga_jax.parallel import partition
from gnn_fpga_jax.train.trainer import Trainer, TrainConfig, stack_batches


def _batched(seed=0, batch=8):
    cfg = toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=seed)
    return toy2d.make_segment_graphs(cfg, batch)


def _mcfg(**kw):
    return mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8,
                                        n_iters=2, **kw)


def _gen(batch=8):
    s = 0
    while True:
        yield _batched(seed=s, batch=batch)
        s += 1


def test_dp_trainer_matches_single_device_losses():
    mcfg = _mcfg(aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), mcfg)
    fn = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)

    t_single = Trainer(fn, params, TrainConfig())
    mesh = mesh_lib.make_mesh()
    t_dp = Trainer(fn, params, TrainConfig(), strategy="dp", mesh=mesh)

    # run both trainers through fit on identical data
    t_single.fit(_gen(), n_batches=4, n_epochs=2)
    t_dp.fit(_gen(), n_batches=4, n_epochs=2)
    np.testing.assert_allclose(t_single.train_losses, t_dp.train_losses,
                               rtol=1e-4)


def test_dp_checkpoint_resume(tmp_path):
    """Checkpoint-resume semantics under DP (VERDICT item 6 done-gate)."""
    mcfg = _mcfg(aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), mcfg)
    fn = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)
    mesh = mesh_lib.make_mesh()

    t1 = Trainer(fn, params, TrainConfig(), strategy="dp", mesh=mesh,
                 checkpoint_dir=str(tmp_path))
    t1.fit(_gen(), n_batches=2, n_epochs=2, valid_generator=_gen(),
           n_valid_batches=1)
    assert t1.epoch == 2

    t2 = Trainer(fn, params, TrainConfig(), strategy="dp", mesh=mesh,
                 checkpoint_dir=str(tmp_path))
    assert t2.load_checkpoint()
    assert t2.epoch == 2
    for a, b in zip(jax.tree.leaves(t1.params), jax.tree.leaves(t2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # continues training from the restored state
    t2.fit(_gen(), n_batches=2, n_epochs=1)
    assert t2.epoch == 3


def test_dp_run_steps_scan():
    mcfg = _mcfg(aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(2), mcfg)
    fn = lambda p, g, m: mpnn.segment_classifier_logits(p, g, mcfg, m)
    mesh = mesh_lib.make_mesh()
    t = Trainer(fn, params, TrainConfig(), strategy="dp", mesh=mesh)
    stacked = stack_batches([_batched(seed=s) for s in range(4)])
    losses = t.run_steps(stacked)
    assert losses.shape == (4,)
    assert np.isfinite(losses).all()


def _partitioned_batch(seed=0, n_parts=8):
    cfg = toy2d.Toy2DConfig(n_layers=6, n_tracks=4, seed=seed)
    g = jax.tree.map(lambda a: a[0], toy2d.make_segment_graphs(cfg, 1))
    return partition.partition_graph(g, n_parts), g


def test_partitioned_trainer_fit_eval_predict(tmp_path):
    mesh = mesh_lib.make_mesh((8,), (mesh_lib.GRAPH_AXIS,))
    mcfg = _mcfg()
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(3), mcfg)
    t = Trainer(None, params, TrainConfig(), strategy="partitioned",
                mesh=mesh, model_cfg=mcfg, checkpoint_dir=str(tmp_path))

    def gen():
        s = 0
        while True:
            yield jax.tree.map(jnp.asarray, _partitioned_batch(seed=s)[0])
            s += 1

    t.fit(gen(), n_batches=2, n_epochs=2, valid_generator=gen(),
          n_valid_batches=1)
    assert len(t.train_losses) == 2 and np.isfinite(t.train_losses).all()
    # predict/evaluate through the sharded forward
    m = t.evaluate(gen(), 1)
    assert 0.0 <= m["accuracy"] <= 1.0
    # checkpoint round-trips
    t2 = Trainer(None, params, TrainConfig(), strategy="partitioned",
                 mesh=mesh, model_cfg=mcfg, checkpoint_dir=str(tmp_path))
    assert t2.load_checkpoint()
    assert t2.epoch == 2


def test_partitioned_trainer_matches_single_loss():
    """First-step loss identical to the single-device Trainer on the same
    graph (exact-match pattern of tests/test_partition.py)."""
    mesh = mesh_lib.make_mesh((8,), (mesh_lib.GRAPH_AXIS,))
    mcfg = _mcfg(aggregation="sparse")
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(4), mcfg)
    pg, g = _partitioned_batch(seed=7)

    t_part = Trainer(None, params, TrainConfig(), strategy="partitioned",
                     mesh=mesh, model_cfg=mcfg)
    fn = lambda p, gr, m: mpnn.segment_classifier_logits(p, gr, mcfg, m)
    t_single = Trainer(fn, params, TrainConfig())

    _, _, loss_p = t_part._train_step(t_part.params, t_part.opt_state,
                                      jax.tree.map(jnp.asarray, pg))
    _, _, loss_s = t_single._train_step(t_single.params,
                                        t_single.opt_state, g)
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5)


def test_partitioned_mixed_precision_runs():
    """bf16 compute in the sharded forward (VERDICT weak 4)."""
    mesh = mesh_lib.make_mesh((8,), (mesh_lib.GRAPH_AXIS,))
    mcfg = _mcfg(compute_dtype=jnp.bfloat16)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(5), mcfg)
    pg, _ = _partitioned_batch(seed=8)
    fwd = partition.make_sharded_forward(mesh, mcfg)
    logits = fwd(params, jax.tree.map(jnp.asarray, pg))
    assert logits.dtype == jnp.float32
    assert np.isfinite(np.asarray(logits)).all()


def test_partitioned_node_classifier_head():
    """Node-target training on a partitioned graph (hit classifier)."""
    mesh = mesh_lib.make_mesh((8,), (mesh_lib.GRAPH_AXIS,))
    rng = np.random.default_rng(9)
    from gnn_fpga_jax.core import graph as G
    v, e = 64, 256
    g = G.from_coo(rng.normal(size=(v, 4)).astype(np.float32),
                   rng.integers(0, v, e), rng.integers(0, v, e),
                   rng.integers(0, 2, e).astype(np.float32),
                   node_y=rng.integers(0, 2, v).astype(np.float32))
    pg = partition.partition_graph(g, 8)
    assert pg.node_y is not None
    ncfg = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=2)
    params = mpnn.init_node_classifier(jax.random.PRNGKey(6), ncfg)
    t = Trainer(None, params, TrainConfig(target="node"),
                strategy="partitioned", mesh=mesh, model_cfg=ncfg)
    _, _, loss = t._train_step(t.params, t.opt_state,
                               jax.tree.map(jnp.asarray, pg))
    # oracle: single-device node classifier on the same graph
    logits = mpnn.node_classifier_logits(params, g, dataclasses.replace(
        ncfg, aggregation="sparse"))
    import optax
    per = optax.sigmoid_binary_cross_entropy(logits, jnp.asarray(g.node_y))
    expect = per.mean()
    np.testing.assert_allclose(float(loss), float(expect), rtol=1e-5)


def test_partitioned_unshared_runs():
    mesh = mesh_lib.make_mesh((8,), (mesh_lib.GRAPH_AXIS,))
    mcfg = _mcfg()
    params = mpnn.init_segment_classifier_unshared(jax.random.PRNGKey(7),
                                                   mcfg)
    pg, g = _partitioned_batch(seed=10)
    fwd = partition.make_sharded_forward(mesh, mcfg, unshared=True)
    logits = np.asarray(fwd(params, jax.tree.map(jnp.asarray, pg)))
    expect = np.asarray(mpnn.segment_classifier_unshared_logits(
        params, g, dataclasses.replace(mcfg, aggregation="sparse")))
    # compare on real (unmasked) edges, reassembled from shards
    em = np.asarray(pg.edge_mask) > 0
    # partitioned edges are a permutation of the original ones; compare
    # sorted logits of real edges
    np.testing.assert_allclose(np.sort(logits[em]),
                               np.sort(expect[np.asarray(g.edge_mask) > 0]),
                               rtol=1e-4, atol=1e-5)
