"""Every aggregation route (sparse, dense, blocked) against the float64
NumPy oracle (`tests/oracle.py`) on layered graphs built to stress
aggregation: random shapes, degree gaps and hot nodes, masked pad edges,
boundary-padded packed graphs, parameter gradients, the node classifier
and unshared weights."""

import jax
import numpy as np
import pytest

from gnn_fpga_jax.core import graph as G
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.ops import blocked as blk

import oracle

ROUTES = ["sparse", "dense", "blocked"]


def layered_graph(seed, per_layer, n_feat=2, degree=2, hot=None,
                  isolated=()):
    """Nodes sorted by layer (``per_layer[l]`` nodes on layer ``l``);
    every edge goes from layer ``l`` to ``l + 1``.  Each receiver draws
    ``degree`` random senders; receiver node ``hot`` gets an edge from
    every node of the layer below; receivers in ``isolated`` get none.
    Returns (graph, layer_offsets)."""
    rng = np.random.default_rng(seed)
    off = np.concatenate([[0], np.cumsum(per_layer)]).astype(np.int64)
    s, r = [], []
    for layer in range(len(per_layer) - 1):
        lo, hi = off[layer], off[layer + 1]
        for j in range(off[layer + 1], off[layer + 2]):
            if j in isolated:
                continue
            n = hi - lo if hot == j else degree
            src = rng.choice(np.arange(lo, hi), size=min(n, hi - lo),
                             replace=False)
            s += list(src)
            r += [j] * len(src)
    x = rng.uniform(-1, 1, size=(off[-1], n_feat)).astype(np.float32)
    y = rng.integers(0, 2, size=len(s)).astype(np.float32)
    node_y = rng.integers(0, 2, size=off[-1]).astype(np.float32)
    return G.from_coo(x, s, r, y, node_y=node_y), off


def packed_layer_major(parts):
    """Pack component graphs into one graph whose nodes stay sorted by
    layer (layer 0 of every component, then layer 1, ...), each
    component padded by masked edges at its boundary."""
    n_layers = len(parts[0][1]) - 1
    order, off = [], [0]
    base = np.cumsum([0] + [g.n_node for g, _ in parts])
    for layer in range(n_layers):
        for c, (g, o) in enumerate(parts):
            order += list(range(base[c] + o[layer], base[c] + o[layer + 1]))
        off.append(len(order))
    new_id = np.empty(len(order), np.int64)
    new_id[order] = np.arange(len(order))
    padded = [G.pad_graph(g, g.n_node, g.n_edge + 3) for g, _ in parts]
    flat = G.pack_graphs(padded)
    return flat.replace(
        x=np.asarray(flat.x)[order],
        node_y=np.asarray(flat.node_y)[order],
        senders=new_id[np.asarray(flat.senders)].astype(np.int32),
        receivers=new_id[np.asarray(flat.receivers)].astype(np.int32),
    ), np.asarray(off, np.int64)


def scenario(name):
    if name == "random_small":
        return layered_graph(0, [5, 5, 5, 5])
    if name == "random_mid":
        return layered_graph(1, [12, 9, 14, 11, 12, 10], degree=3)
    if name == "random_wide":
        return layered_graph(2, [40, 40, 40], n_feat=5, degree=4)
    if name == "hot_nodes_gaps":
        return layered_graph(3, [30, 4, 25, 6], degree=1, hot=32,
                             isolated=(30, 31, 60, 61, 62))
    if name == "masked_pad":
        g, off = layered_graph(4, [8, 8, 8, 8], degree=3)
        return G.pad_graph(g, g.n_node + 3, g.n_edge + 10), off
    if name == "packed_boundary":
        return packed_layer_major([layered_graph(10 + c, [6, 7, 5, 6])
                                   for c in range(3)])
    # gradients / node classifier / unshared run on a mid-size graph
    return layered_graph(5, [10, 12, 8, 11, 9], degree=3)


SCENARIOS = ["random_small", "random_mid", "random_wide", "hot_nodes_gaps",
             "masked_pad", "packed_boundary", "grads", "node_classifier",
             "unshared"]


def for_route(g, off, route):
    return blk.attach_blocks_layered(g, off, group=2) if route == "blocked" \
        else g


def dense_inputs(g):
    x, ri, ro, _ = G.to_dense_incidence(g)
    return (np.asarray(x, np.float64), ri.astype(np.float64),
            ro.astype(np.float64))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_route_matches_oracle(name, route):
    g, off = scenario(name)
    g = for_route(g, off, route)
    x, ri, ro = dense_inputs(g)
    real = np.asarray(g.edge_mask) > 0
    n_feat = g.n_feature
    key = jax.random.PRNGKey(SCENARIOS.index(name))

    if name == "node_classifier":
        cfg = mpnn.NodeClassifierConfig(input_dim=n_feat, hidden_dim=8,
                                        n_iters=2, aggregation=route)
        params = mpnn.init_node_classifier(key, cfg)
        got = np.asarray(mpnn.node_classifier(params, g, cfg))
        want = oracle.node_classifier_dense(params, x, ri, ro, 2)
        nodes = np.asarray(g.node_mask) > 0
        np.testing.assert_allclose(got[nodes], want[nodes], atol=2e-5)
        return

    cfg = mpnn.SegmentClassifierConfig(input_dim=n_feat, hidden_dim=8,
                                       n_iters=3, aggregation=route)
    if name == "unshared":
        params = mpnn.init_segment_classifier_unshared(key, cfg)
        got = np.asarray(mpnn.segment_classifier_unshared(params, g, cfg))
        want = oracle.segment_classifier_unshared_dense(params, x, ri, ro, 3)
        np.testing.assert_allclose(got[real], want[real], atol=2e-5)
        return

    params = mpnn.init_segment_classifier(key, cfg)
    got = np.asarray(mpnn.segment_classifier(params, g, cfg))
    want = oracle.segment_classifier_dense(params, x, ri, ro, 3)
    np.testing.assert_allclose(got[real], want[real], atol=2e-5)

    if name == "grads":
        from gnn_fpga_jax.train.trainer import masked_bce_with_logits

        def loss(p):
            logits = mpnn.segment_classifier_logits(p, g, cfg)
            return masked_bce_with_logits(logits, g.y, g.edge_mask)

        grads = jax.grad(loss)(params)
        ref = oracle.segment_classifier_bce_grads(
            params, x[None], ri[None], ro[None], np.asarray(g.y)[None],
            np.asarray(g.edge_mask)[None], 3)
        for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(ref)):
            np.testing.assert_allclose(np.asarray(a), b,
                                       atol=1e-5 * max(np.abs(b).max(), 1))
