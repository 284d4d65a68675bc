"""Tests for the full-event (adjacency-window) and candidate-graph data
pipelines (`MPNN_Seg_ACTS_fullEvents.ipynb`, `MPNN_HitClassifier.ipynb`)."""

import numpy as np
import pandas as pd
import pytest

from gnn_fpga_jax.data import candidates, full_events


def _hits_df(n_tracks=4, n_layers=6, n_noise=0, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in range(1, n_tracks + 1):
        phi0 = rng.uniform(-np.pi, np.pi)
        zsl = rng.uniform(-0.3, 0.3)
        for lay in range(n_layers):
            r = 100.0 * (lay + 1)
            rows.append({"evtid": 0, "barcode": pid, "layer": lay,
                         "r": r, "phi": phi0 + rng.normal(0, 0.01),
                         "z": zsl * r})
    for k in range(n_noise):
        rows.append({"evtid": 0, "barcode": 1000 + k,
                     "layer": int(rng.integers(0, n_layers)),
                     "r": 100.0, "phi": rng.uniform(-np.pi, np.pi),
                     "z": rng.uniform(-300, 300)})
    return pd.DataFrame(rows)


def test_full_events_adjacency_window():
    hits = _hits_df(n_tracks=3, n_layers=4)
    cfg = full_events.FullEventConfig(dphi_max=0.1, dz_max=1e9,
                                      n_nodes_min=None, n_nodes_max=None,
                                      n_edges_max=None)
    g = full_events.construct_graph(hits, cfg)
    layers = hits.layer.to_numpy()
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    # edges only between adjacent layers
    np.testing.assert_array_equal(layers[r], layers[s] + 1)
    # tight dphi window keeps mostly same-track pairs => labels all true
    assert np.asarray(g.y).mean() > 0.9
    # feature scaling: phi / pi
    np.testing.assert_allclose(np.asarray(g.x)[:, 1],
                               hits.phi.to_numpy() / np.pi, rtol=1e-5)


def test_full_events_occupancy_filter():
    hits = _hits_df(n_tracks=2, n_layers=3)
    cfg = full_events.FullEventConfig(n_nodes_min=50)
    graphs = full_events.build_event_graphs(hits, cfg=cfg)
    assert graphs == []  # 6 nodes < min 50
    cfg2 = full_events.FullEventConfig(n_nodes_min=None, n_nodes_max=None,
                                       n_edges_max=None)
    graphs2 = full_events.build_event_graphs(hits, cfg=cfg2)
    assert len(graphs2) == 1


def test_candidate_graph_shapes_and_seeds():
    cfg = candidates.CandidateConfig(n_det_layers=4, n_layer_hits=3,
                                     n_seed_layers=2)
    hits = _hits_df(n_tracks=5, n_layers=4, seed=1)
    g = candidates.build_candidate_graph(hits, pid=1, cfg=cfg)
    assert g is not None
    assert g.n_node == 12                       # 4 layers x 3 candidates
    assert g.n_edge == 3 * 3 * 3                # 3 layer pairs x 3x3
    node_y = np.asarray(g.node_y)
    assert node_y.sum() == 4                    # one true hit per layer
    # seed feature equals truth on seed layers, zero elsewhere
    seed = np.asarray(g.x)[:, -1]
    layers = np.repeat(np.arange(4), 3)
    np.testing.assert_array_equal(seed[layers >= 2], 0.0)
    np.testing.assert_array_equal(seed[layers < 2], node_y[layers < 2])
    # edge labels: true iff both endpoints true
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    np.testing.assert_array_equal(np.asarray(g.y), node_y[s] * node_y[r])


def test_candidate_graph_phi_centered():
    cfg = candidates.CandidateConfig(n_det_layers=4, n_layer_hits=2)
    hits = _hits_df(n_tracks=3, n_layers=4, seed=2)
    g = candidates.build_candidate_graph(hits, pid=2, cfg=cfg)
    # true hits' phi is ~0 after centering (they share phi0 up to noise)
    x = np.asarray(g.x)
    node_y = np.asarray(g.node_y) > 0
    assert np.abs(x[node_y, 1]).max() < 0.05 / np.pi * np.pi  # small


def test_candidate_dataset_skips_incomplete_tracks():
    cfg = candidates.CandidateConfig(n_det_layers=4, n_layer_hits=2)
    hits = _hits_df(n_tracks=3, n_layers=4, seed=3)
    hits = hits[~((hits.barcode == 1) & (hits.layer == 2))]  # break track 1
    graphs = candidates.build_candidate_dataset(hits, cfg)
    assert len(graphs) == 2


def test_candidate_training_end_to_end():
    """NodeClassifier on candidate graphs learns past the seed baseline —
    the MPNN_HitClassifier workload in miniature (`cell35`: acc 0.994)."""
    import jax
    from gnn_fpga_jax.core.graph import batch_graphs
    from gnn_fpga_jax.models import mpnn
    from gnn_fpga_jax.train.trainer import Trainer, TrainConfig

    cfg = candidates.CandidateConfig(n_det_layers=4, n_layer_hits=3,
                                     n_seed_layers=2)
    graphs = []
    for seed in range(48):
        hits = _hits_df(n_tracks=5, n_layers=4, seed=seed)
        g = candidates.build_candidate_graph(hits, pid=1, cfg=cfg)
        if g is not None:
            graphs.append(g)
    assert len(graphs) >= 40
    batched = batch_graphs(graphs[:40])

    def gen():
        while True:
            yield jax.tree.map(jax.numpy.asarray, batched)

    mcfg = mpnn.NodeClassifierConfig(input_dim=4, hidden_dim=8, n_iters=2)
    params = mpnn.init_node_classifier(jax.random.PRNGKey(0), mcfg)
    tr = Trainer(lambda p, g, m: mpnn.node_classifier_logits(p, g, mcfg, m),
                 params, TrainConfig(target="node", learning_rate=1e-2))
    tr.fit(gen(), n_batches=1, n_epochs=200)
    m = tr.evaluate(gen(), 1)
    assert m["accuracy"] > 0.85, m


def test_knn_segment_graphs_static_shapes_and_labels():
    """k-NN windowed candidate edges: exact static shapes, receivers on the
    next layer, k distinct nearest senders, labels = same-track endpoints."""
    import numpy as np
    from gnn_fpga_jax.data import toy2d

    cfg = toy2d.Toy2DConfig(n_layers=6, n_tracks=9, seed=3)
    k, n_events = 4, 5
    g = toy2d.make_knn_segment_graphs(cfg, n_events, k=k)
    nl, nt = cfg.n_layers, cfg.n_tracks
    assert g.senders.shape == (n_events, (nl - 1) * nt * k)
    assert g.x.shape == (n_events, nl * nt, 2)
    x, y, r, l = toy2d.generate_events(cfg, n_events)
    s, rcv = np.asarray(g.senders), np.asarray(g.receivers)
    # receiver exactly one layer above sender
    assert ((rcv // nt) - (s // nt) == 1).all()
    # the k senders per receiver are the k nearest in |dx| (set equality
    # against a brute-force oracle) and distinct
    ev, layer, hit = 2, 3, 5
    ridx = (layer + 1) * nt + hit
    mask = rcv[ev] == ridx
    got = np.sort(s[ev][mask])
    dx = np.abs(x[ev, layer * nt:(layer + 1) * nt] - x[ev, ridx])
    want = np.sort(layer * nt + np.argsort(dx)[:k])
    np.testing.assert_array_equal(got, want)
    # labels
    ey = (y[np.arange(n_events)[:, None], s]
          == y[np.arange(n_events)[:, None], rcv])
    np.testing.assert_array_equal(np.asarray(g.y), ey.astype(np.float32))
    # true-segment retention is high (the windows are doublet cuts)
    kept = float(np.asarray(g.y).sum()) / (n_events * (nl - 1) * nt)
    assert kept > 0.9


def test_exploration_track_spans_and_deltas():
    """Characterization utilities match a pandas groupby oracle
    (`ActsExplore1.ipynb:cell14,18`)."""
    import numpy as np
    import pandas as pd
    from gnn_fpga_jax.data import exploration as ex

    rng = np.random.default_rng(5)
    rows = []
    for ev in range(3):
        for pid in range(4):
            n = rng.integers(2, 6)
            r = np.sort(rng.uniform(30, 1000, n))
            phi0 = rng.uniform(-np.pi, np.pi)
            phi = phi0 + np.cumsum(rng.normal(0, 0.02, n))
            phi = (phi + np.pi) % (2 * np.pi) - np.pi
            z = rng.uniform(-200, 200, n)
            for i in range(n):
                rows.append((ev, pid, r[i], phi[i], z[i],
                             float(np.arcsinh(z[i] / r[i]))))
    hits = pd.DataFrame(rows, columns=["evtid", "barcode", "r", "phi",
                                       "z", "eta"])
    hits = hits.sample(frac=1.0, random_state=0)  # shuffle rows

    spans = ex.track_spans(hits)
    # oracle via groupby
    def dphi_fl(df):
        phi = df.sort_values("r").phi.values
        d = abs(phi[-1] - phi[0])
        return 2 * np.pi - d if d > np.pi else d
    g = hits.groupby(["evtid", "barcode"])
    np.testing.assert_array_equal(np.sort(spans["nhits"]),
                                  np.sort(g.size().values))
    np.testing.assert_allclose(np.sort(spans["dphi"]),
                               np.sort(g.apply(dphi_fl, include_groups=False).values),
                               rtol=1e-6)
    np.testing.assert_allclose(
        np.sort(spans["deta"]),
        np.sort((g.eta.max() - g.eta.min()).values), rtol=1e-6)

    particles = pd.DataFrame(
        [(ev, pid, rng.uniform(-np.pi, np.pi), rng.uniform(-2, 2))
         for ev in range(3) for pid in range(4)],
        columns=["evtid", "barcode", "phi", "eta"])
    mult = ex.multiplicities(hits, particles)
    assert (mult["tracks_per_event"] == 4).all()
    assert mult["hits_per_event"].sum() == len(hits)

    deltas = ex.hit_particle_deltas(hits, particles)
    n_pairs = sum((hits.evtid == ev).sum() * 4 for ev in range(3))
    n_sig = len(deltas["signal"]["dr"])
    n_bkg = len(deltas["background"]["dr"])
    assert n_sig + n_bkg == n_pairs
    assert n_sig == len(hits)  # every hit matches exactly its own particle
    assert (deltas["signal"]["dr"] >= 0).all()

    occ = ex.layer_occupancy(hits.assign(volid=8, layid=2))
    assert occ[(8, 2)] == len(hits)
