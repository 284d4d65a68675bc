"""Data-layer tests: doublet selection vs a pandas-merge oracle, TrackML
hit selection, phi sectors, ACTS parsing, muon pipeline — the reference's
golden-small-event validation strategy (SURVEY.md §4) as pytest."""

import io
import textwrap

import numpy as np
import pandas as pd
import pytest

from gnn_fpga_jax.data import acts, doublets, muon, selection
from gnn_fpga_jax.data.doublets import (
    ColumnSchema, SegmentCuts, TRACKML_SCHEMA, calc_dphi)


# ---------------------------------------------------------------------------
# Fixtures: small deterministic events
# ---------------------------------------------------------------------------

def toy_hits(n_tracks=5, n_layers=4, seed=0):
    """Straight tracks in (r, phi, z): phi constant, z linear in r."""
    rng = np.random.default_rng(seed)
    phi0 = rng.uniform(-np.pi, np.pi, n_tracks)
    z_slope = rng.uniform(-0.5, 0.5, n_tracks)
    rows = []
    for pid in range(n_tracks):
        for layer in range(n_layers):
            r = 10.0 * (layer + 1)
            rows.append({
                "evtid": 0, "layer": layer, "r": r,
                "phi": phi0[pid], "z": z_slope[pid] * r,
                "particle_id": pid + 1,
            })
    return pd.DataFrame(rows)


def oracle_select_segments(hits1, hits2, phi_slope_cut, z0_max):
    """The reference's pandas-merge algorithm (`graph.py:44-66`),
    reimplemented as a test oracle."""
    keys = ["evtid", "layer", "r", "phi", "z"]
    pairs = hits1[keys].reset_index().merge(
        hits2[keys].reset_index(), on="evtid", suffixes=("_1", "_2"))
    dphi = calc_dphi(pairs.phi_1.to_numpy(), pairs.phi_2.to_numpy())
    dz = pairs.z_2 - pairs.z_1
    dr = pairs.r_2 - pairs.r_1
    phi_slope = dphi / dr
    z0 = pairs.z_1 - pairs.r_1 * dz / dr
    good = (np.abs(phi_slope) < phi_slope_cut) & (np.abs(z0) < z0_max)
    return set(zip(pairs["index_1"][good.to_numpy()],
                   pairs["index_2"][good.to_numpy()]))


# ---------------------------------------------------------------------------
# Doublet engine
# ---------------------------------------------------------------------------

def test_select_segments_matches_pandas_oracle():
    hits = toy_hits(n_tracks=8, n_layers=3, seed=3)
    # Perturb so cuts actually reject some pairs
    rng = np.random.default_rng(0)
    hits["phi"] += rng.normal(0, 0.02, len(hits))
    hits["z"] += rng.normal(0, 5.0, len(hits))
    h1 = hits[hits.layer == 0]
    h2 = hits[hits.layer == 1]
    cut, z0m = 0.004, 150.0
    i1, i2 = doublets.select_segments_arrays(
        h1.r.to_numpy(), h1.phi.to_numpy(), h1.z.to_numpy(),
        h2.r.to_numpy(), h2.phi.to_numpy(), h2.z.to_numpy(), cut, z0m)
    ours = set(zip(h1.index.to_numpy()[i1], h2.index.to_numpy()[i2]))
    assert ours == oracle_select_segments(h1, h2, cut, z0m)
    assert len(ours) > 0


def test_construct_graph_labels_and_topology():
    hits = toy_hits(n_tracks=4, n_layers=4)
    g = doublets.construct_graph(
        hits, doublets.adjacent_layer_pairs(4),
        cuts=SegmentCuts(phi_slope_max=1e-4, z0_max=1e6),
        feature_names=["r", "phi", "z"],
        feature_scale=np.array([1000.0, np.pi, 1000.0]))
    # Tight phi-slope cut keeps only same-track (phi-constant) segments:
    # all edges true, one per track per layer pair.
    y = np.asarray(g.y)
    assert len(y) == 4 * 3
    assert y.min() == 1.0
    # Edges connect consecutive layers
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    layers = hits.layer.to_numpy()
    np.testing.assert_array_equal(layers[r], layers[s] + 1)
    # Feature scaling applied
    np.testing.assert_allclose(np.asarray(g.x)[:, 0],
                               hits.r.to_numpy() / 1000.0, rtol=1e-6)


def test_construct_graph_layer_dependent_cut():
    """Inner pairs use phi_slope_max, outer (layer >= inner_layer_max) use
    phi_slope_outer_max (`graph.py:65`)."""
    hits = toy_hits(n_tracks=3, n_layers=7)
    rng = np.random.default_rng(1)
    hits["phi"] += rng.normal(0, 1e-3, len(hits))
    open_cuts = SegmentCuts(phi_slope_max=1e9, phi_slope_outer_max=1e-9,
                            z0_max=1e9, inner_layer_max=5)
    g = doublets.construct_graph(hits, doublets.adjacent_layer_pairs(7),
                                 cuts=open_cuts)
    layers = hits.layer.to_numpy()
    s = np.asarray(g.senders)
    # No edges from layers >= 5 survive the closed outer cut
    assert (layers[s] < 5).all()
    # But inner edges do survive the open inner cut
    assert len(s) > 0


def test_construct_graph_empty_layer_skipped():
    hits = toy_hits(n_tracks=2, n_layers=3)
    hits = hits[hits.layer != 1]  # empty middle layer
    g = doublets.construct_graph(hits, [(0, 1), (1, 2), (0, 2)],
                                 cuts=SegmentCuts())
    assert g is not None  # (0,2) pairs still built; empty pairs skipped
    assert g.n_edge == 4  # 2x2 cross join of layers 0 and 2


def test_construct_graph_no_segments_returns_none():
    hits = toy_hits(n_tracks=2, n_layers=2)
    g = doublets.construct_graph(
        hits, [(0, 1)], cuts=SegmentCuts(phi_slope_max=0.0, z0_max=0.0))
    assert g is None


def test_dynamic_layer_pairs_sign_split():
    pairs = doublets.dynamic_layer_pairs([1, 3, 8, -2, -5, 3])
    pl = {tuple(p) for p in pairs.tolist()}
    # Both sides pair inner->outer: positive ascending, negative from the
    # least-negative (|layer| small) outward (`prepareMuonGraphs.py:238-241`:
    # stack([l_minus[1:], l_minus[:-1]])).
    assert pl == {(1, 3), (3, 8), (-2, -5)}


# ---------------------------------------------------------------------------
# TrackML hit selection + sectors
# ---------------------------------------------------------------------------

def _trackml_event(n_tracks=3, pt=2.0, seed=0):
    rng = np.random.default_rng(seed)
    hits_rows, truth_rows, part_rows = [], [], []
    hid = 1
    for pid in range(1, n_tracks + 1):
        phi0 = rng.uniform(-np.pi, np.pi)
        part_rows.append({"particle_id": pid, "px": pt * np.cos(phi0),
                          "py": pt * np.sin(phi0), "pz": 0.1})
        for (vol, lay) in selection.BARREL_VLIDS:
            r = 30.0 * (lay / 2)
            hits_rows.append({"hit_id": hid, "x": r * np.cos(phi0),
                              "y": r * np.sin(phi0), "z": 0.05 * r,
                              "volume_id": vol, "layer_id": lay})
            truth_rows.append({"hit_id": hid, "particle_id": pid})
            hid += 1
    # one noise hit in a non-barrel volume
    hits_rows.append({"hit_id": hid, "x": 1.0, "y": 1.0, "z": 0.0,
                      "volume_id": 7, "layer_id": 2})
    truth_rows.append({"hit_id": hid, "particle_id": 0})
    part_rows.append({"particle_id": 0, "px": 0.0, "py": 0.0, "pz": 0.0})
    return (pd.DataFrame(hits_rows), pd.DataFrame(truth_rows),
            pd.DataFrame(part_rows))


def test_select_hits_barrel_and_pt_cut():
    hits, truth, particles = _trackml_event(n_tracks=3, pt=2.0)
    out = selection.select_hits(hits, truth, particles, pt_min=1.0)
    assert set(out.layer.unique()) == set(range(10))
    assert len(out) == 30          # 3 tracks x 10 layers; noise dropped
    assert (out.particle_id > 0).all()
    # pt cut removes everything when above track pt
    out2 = selection.select_hits(hits, truth, particles, pt_min=5.0)
    assert len(out2) == 0


def test_select_hits_dedup_min_r():
    hits, truth, particles = _trackml_event(n_tracks=1)
    # Duplicate first hit with larger r on the same layer
    dup = hits.iloc[[0]].assign(hit_id=999, x=hits.iloc[0].x * 2,
                                y=hits.iloc[0].y * 2)
    hits = pd.concat([hits, dup], ignore_index=True)
    truth = pd.concat([truth, pd.DataFrame([{"hit_id": 999,
                                             "particle_id": 1}])],
                      ignore_index=True)
    out = selection.select_hits(hits, truth, particles)
    assert len(out) == 10
    assert 999 not in out.hit_id.values  # min-r kept


def test_split_phi_sectors_centering():
    hits, truth, particles = _trackml_event(n_tracks=8, seed=2)
    out = selection.select_hits(hits, truth, particles)
    sectors = selection.split_phi_sectors(out, n_phi_sectors=8)
    assert len(sectors) == 8
    width = 2 * np.pi / 8
    total = sum(len(s) for s in sectors)
    assert total == len(out)  # boundary-exact hits aside
    for s in sectors:
        if len(s):
            assert np.abs(s.phi.to_numpy()).max() <= width / 2 + 1e-9


# ---------------------------------------------------------------------------
# ACTS parsing
# ---------------------------------------------------------------------------

ACTS_HITS_FILE = textwrap.dedent("""\
    # hits
    [0, 11, 8, 2, [0.1, 0.2], [0.0, 0.0], [10.0, 0.0, 1.0], [1], [0.0], [0.0]]
    [1, 11, 8, 4, [0.1, 0.2], [0.0, 0.0], [0.0, 20.0, 2.0], [1], [0.0], [0.0]]

    [0, 12, 13, 2, [0.1, 0.2], [0.0, 0.0], [-30.0, 0.0, 3.0], [1], [0.0], [0.0]]

""")


def test_acts_load_and_process(tmp_path):
    p = tmp_path / "hits.txt"
    p.write_text(ACTS_HITS_FILE)
    df = acts.load_data_events(str(p), acts.HITS_COLUMNS)
    assert df.evtid.tolist() == [0, 0, 1]
    out = acts.process_hits_data(df)
    np.testing.assert_allclose(out.r.to_numpy(), [10.0, 20.0, 30.0])
    np.testing.assert_allclose(out.phi.to_numpy()[1], np.pi / 2)
    np.testing.assert_allclose(out.z.to_numpy(), [1.0, 2.0, 3.0])


def test_acts_barrel_relayering():
    df = pd.DataFrame({
        "evtid": [0, 0, 0, 0],
        "barcode": [1, 1, 1, 1],
        "volid": [8, 13, 17, 7],      # last is non-barrel
        "layid": [2, 4, 2, 2],
        "r": [1.0, 2.0, 3.0, 4.0],
        "phi": [0.0] * 4,
        "z": [0.0] * 4,
    })
    out = acts.select_barrel_hits(df)
    assert len(out) == 3
    # layer = layid/2 - 1 + volume*4  (`acts.py:126-127`)
    assert out.layer.tolist() == [0, 5, 8]


def test_acts_consistency_check():
    h = pd.DataFrame({"evtid": [0, 0], "barcode": [1, 2]})
    p_good = pd.DataFrame({"evtid": [0, 0], "barcode": [1, 2]})
    p_bad = pd.DataFrame({"evtid": [0], "barcode": [1]})
    assert acts.data_consistent(h, p_good)
    assert not acts.data_consistent(h, p_bad)


# ---------------------------------------------------------------------------
# Muon pipeline
# ---------------------------------------------------------------------------

def _muon_df(entries, z_sign=1, tp=0, station_seq=((1, 1, 1), (1, 2, 1), (1, 3, 1))):
    """Signal-like hits: one hit per (type, station, ring) triple/entry."""
    rows = []
    for e in entries:
        for i, (t, s, rg) in enumerate(station_seq):
            rows.append({
                "entry": e, "vh_type": t, "vh_station": s, "vh_ring": rg,
                "vh_sim_z": z_sign * (600.0 + 100 * i),
                "vh_sim_theta": 0.3, "vh_sim_phi": 0.5,
                "vh_sim_r": 200.0 + 10 * i, "vh_bend": 0.0,
                "vh_sim_tp1": tp, "vh_sim_tp2": tp,
            })
    return pd.DataFrame(rows)


def test_emtf_lut_matches_reference_assignments():
    assert muon.get_layer(1, 1, 1) == 3     # ME1/1b
    assert muon.get_layer(2, 4, 3) == 12    # RE4/3
    assert muon.get_layer(3, 1, 1) == 2     # GE1/1
    assert muon.get_layer(4, 1, 1) == 1     # ME0
    assert muon.get_layer(0, 1, 1) == -99   # DT unmapped


def test_assign_layers_drops_unmapped():
    df = _muon_df([0])
    df.loc[0, "vh_type"] = 0  # DT -> unmapped
    out = muon.assign_layers(df)
    assert len(out) == 2


def test_prepare_hits_mixing_and_signs():
    sig = _muon_df([0, 1], z_sign=1)
    pu = _muon_df([0, 1], z_sign=-1,
                  station_seq=((2, 1, 2), (2, 2, 2)))
    mixed, muon_only = muon.prepare_hits(sig, pu)
    assert set(mixed) == {0, 1}
    ev0 = mixed[0]
    # PU hits have negative layer (z<0 sign split), isMuon 0
    pu_hits = ev0[ev0.isMuon == 0]
    assert (pu_hits.vh_layer < 0).all()
    sig_hits = ev0[ev0.isMuon == 1]
    assert (sig_hits.vh_layer > 0).all()
    # truth filter: non-matched signal dropped
    sig_bad = _muon_df([0], tp=1)
    mixed2, _ = muon.prepare_hits(sig_bad, pu)
    assert all((ev.isMuon == 0).all() for ev in mixed2.values())


def test_muon_build_graphs_labels_and_extras(tmp_path):
    sig = _muon_df([0], z_sign=1)
    pu = _muon_df([0], z_sign=1, station_seq=((2, 1, 2), (2, 2, 2)))
    gen = pd.DataFrame({"vp_pt": [22.5], "vp_eta": [1.7]}, index=[0])
    graphs = muon.build_graphs(sig, pu, gen_properties=gen)
    assert len(graphs) == 1
    entry, g, extras = graphs[0]
    assert extras["pt"] == np.float32(22.5)
    y = np.asarray(g.y)
    assert len(y) > 0
    # mixed event: some edges false (PU-involved), signal chain true
    assert 0.0 < y.mean() <= 1.0
    paths = muon.save_graphs(graphs, str(tmp_path))
    from gnn_fpga_jax.core.graph import load_npz_with_extras
    g2, ex = load_npz_with_extras(paths[0])
    assert float(ex["pt"]) == np.float32(22.5)
    np.testing.assert_allclose(np.asarray(g2.y), y)


# ---------------------------------------------------------------------------
# Native (C++) doublet selection
# ---------------------------------------------------------------------------

def test_native_matches_numpy():
    """The C++ path must agree exactly with the numpy broadcast path."""
    from gnn_fpga_jax.data import native
    if not native.available():
        pytest.skip("native library not built (make -C native)")
    rng = np.random.default_rng(7)
    n1, n2 = 173, 211
    r1 = rng.uniform(20, 40, n1); r2 = rng.uniform(50, 70, n2)
    p1 = rng.uniform(-np.pi, np.pi, n1); p2 = rng.uniform(-np.pi, np.pi, n2)
    z1 = rng.uniform(-200, 200, n1); z2 = rng.uniform(-200, 200, n2)
    cut, z0m = 0.02, 150.0
    i1n, i2n = doublets.select_segments_arrays(
        r1, p1, z1, r2, p2, z2, cut, z0m, use_native=False)
    i1c, i2c = native.select_segments_native(r1, p1, z1, r2, p2, z2, cut, z0m)
    assert set(zip(i1n.tolist(), i2n.tolist())) \
        == set(zip(i1c.tolist(), i2c.tolist()))
    assert len(i1c) > 0


def test_native_capacity_retry():
    """Wide-open cuts force the capacity-miss retry path."""
    from gnn_fpga_jax.data import native
    if not native.available():
        pytest.skip("native library not built")
    n = 64
    r1 = np.linspace(1, 2, n); r2 = np.linspace(3, 4, n)
    zeros = np.zeros(n)
    i1, i2 = native.select_segments_native(
        r1, zeros, zeros, r2, zeros, zeros, 1e30, 1e30)
    assert len(i1) == n * n  # every pair survives


def test_construct_graph_uses_native_consistently():
    """construct_graph output is identical with and without the native path."""
    hits = toy_hits(n_tracks=6, n_layers=4, seed=9)
    rng = np.random.default_rng(1)
    hits["phi"] += rng.normal(0, 0.01, len(hits))
    cuts = SegmentCuts(phi_slope_max=0.004, z0_max=500.0)
    pairs = doublets.adjacent_layer_pairs(4)
    g_native = doublets.construct_graph(hits, pairs, cuts=cuts)
    import gnn_fpga_jax.data.native as native_mod
    orig = native_mod.select_segments_native
    native_mod.select_segments_native = lambda *a, **k: None  # force numpy
    try:
        g_numpy = doublets.construct_graph(hits, pairs, cuts=cuts)
    finally:
        native_mod.select_segments_native = orig
    np.testing.assert_array_equal(np.asarray(g_native.senders),
                                  np.asarray(g_numpy.senders))
    np.testing.assert_array_equal(np.asarray(g_native.receivers),
                                  np.asarray(g_numpy.receivers))
    np.testing.assert_allclose(np.asarray(g_native.y), np.asarray(g_numpy.y))
