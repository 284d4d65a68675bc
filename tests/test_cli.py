"""End-to-end CLI tests on synthetic TrackML-format events: the full
prepare -> train -> infer -> plot pipeline (`SURVEY.md §3` call stacks)."""

import glob
import os

import jax
import numpy as np
import pandas as pd
import pytest

from gnn_fpga_jax.data import selection


def write_trackml_events(tmp_path, n_events=4, n_tracks=6, seed=0):
    """Synthetic TrackML CSV triplets: straight barrel tracks."""
    rng = np.random.default_rng(seed)
    for ev in range(n_events):
        hits_rows, truth_rows, part_rows = [], [], []
        hid = 1
        for pid in range(1, n_tracks + 1):
            phi0 = rng.uniform(-np.pi, np.pi)
            pt = rng.uniform(1.5, 5.0)
            z_slope = rng.uniform(-0.2, 0.2)
            part_rows.append({"particle_id": pid,
                              "px": pt * np.cos(phi0),
                              "py": pt * np.sin(phi0), "pz": 0.1})
            for (vol, lay) in selection.BARREL_VLIDS:
                r = 40.0 * (lay / 2) + 30 * list(
                    dict.fromkeys(v for v, _ in selection.BARREL_VLIDS)
                ).index(vol)
                hits_rows.append({
                    "hit_id": hid,
                    "x": r * np.cos(phi0), "y": r * np.sin(phi0),
                    "z": z_slope * r, "volume_id": vol, "layer_id": lay})
                truth_rows.append({"hit_id": hid, "particle_id": pid})
                hid += 1
        prefix = tmp_path / f"event{ev:09d}"
        pd.DataFrame(hits_rows).to_csv(f"{prefix}-hits.csv", index=False)
        pd.DataFrame(part_rows).to_csv(f"{prefix}-particles.csv", index=False)
        pd.DataFrame(truth_rows).to_csv(f"{prefix}-truth.csv", index=False)


def test_prepare_train_infer_plot_pipeline(tmp_path):
    from gnn_fpga_jax.cli import infer, plot_graph, prepare_graphs, train

    data_dir = tmp_path / "raw"
    graph_dir = tmp_path / "graphs"
    out_dir = tmp_path / "run"
    data_dir.mkdir()
    write_trackml_events(data_dir, n_events=4, n_tracks=6)

    # prepare: single sector (open-ish cuts so toy tracks survive)
    graphs = prepare_graphs.main([
        "--input-dir", str(data_dir), "--output-dir", str(graph_dir),
        "--n-files", "4", "--pt-min", "1", "--n-phi-sectors", "1",
        "--phi-slope-max", "0.1", "--phi-slope-outer-max", "0.1",
        "--z0-max", "1000"])
    assert len(graphs) > 0
    npzs = sorted(glob.glob(str(graph_dir / "*.npz")))
    assert len(npzs) == len(graphs)

    # train 2 epochs, batch 2
    trainer = train.main([
        "--input-dir", str(graph_dir), "--output-dir", str(out_dir),
        "--n-samples", "8", "--batch-size", "2", "--n-epochs", "2",
        "--hidden-dim", "8", "--n-iters", "2",
        "--valid-frac", "0.0", "--test-frac", "0.0"])
    assert len(trainer.train_losses) == 2
    assert os.path.exists(out_dir / "model.npz")
    assert os.path.exists(out_dir / "losses.npz")

    # resume continues epoch numbering
    trainer2 = train.main([
        "--input-dir", str(graph_dir), "--output-dir", str(out_dir),
        "--n-samples", "8", "--batch-size", "2", "--n-epochs", "1",
        "--hidden-dim", "8", "--n-iters", "2",
        "--valid-frac", "0.0", "--test-frac", "0.0", "--resume"])
    assert trainer2.epoch == 3

    # infer with the saved model
    results = infer.main([
        "--model", str(out_dir / "model.npz"),
        "--input-dir", str(graph_dir), "--n-graphs", "2",
        "--hidden-dim", "8", "--n-iters", "2",
        "--output", str(out_dir / "scores.json")])
    assert len(results) == 2
    assert all(0.0 <= r["mean_score"] <= 1.0 for r in results)
    assert os.path.exists(out_dir / "scores.json")

    # infer round-trips the params exactly
    params = infer.load_params(str(out_dir / "model.npz"))
    np.testing.assert_array_equal(
        params["edge"]["l1"]["w"], np.asarray(trainer2.params["edge"]["l1"]["w"]))


def test_plot_graph_cli(tmp_path):
    """Plot CLI renders muon graphs passing the pt/eta cuts."""
    from gnn_fpga_jax.cli import plot_graph
    from gnn_fpga_jax.core.graph import from_coo, save_npz

    x = np.array([[0.0, 0, 0, 10.0, 0, 0, 0, 0, 0, 0, 1.0],
                  [1.0, 0, 0, 20.0, 0, 0, 0, 0, 0, 0, 2.0],
                  [2.0, 0, 0, 30.0, 0, 0, 0, 0, 0, 0, 3.0]], np.float32)
    g = from_coo(x, [0, 1], [1, 2], [1.0, 0.0])
    gdir = tmp_path / "graphs"
    gdir.mkdir()
    save_npz(g, str(gdir / "g0.npz"), pt=np.float32(25.0), eta=np.float32(1.8))
    save_npz(g, str(gdir / "g1.npz"), pt=np.float32(5.0), eta=np.float32(1.8))

    n = plot_graph.main(["--directory", str(gdir),
                         "--outputname", str(tmp_path / "plots")])
    assert n == 1  # only the pt=25 graph passes the cut
    assert len(glob.glob(str(tmp_path / "plots" / "*.png"))) == 1


def test_train_cli_blocked_path_from_npz(tmp_path):
    """The front door reaches the blocked path (VERDICT r4 missing
    #1): prepare writes per-node layer arrays into the NPZ, train routes
    --aggregation blocked through per-graph layer offsets."""
    from gnn_fpga_jax.cli import prepare_graphs, train

    data_dir = tmp_path / "raw"
    graph_dir = tmp_path / "graphs"
    data_dir.mkdir()
    write_trackml_events(data_dir, n_events=6, n_tracks=6, seed=1)
    prepare_graphs.main([
        "--input-dir", str(data_dir), "--output-dir", str(graph_dir),
        "--n-files", "6", "--pt-min", "1", "--n-phi-sectors", "1",
        "--phi-slope-max", "0.1", "--phi-slope-outer-max", "0.1",
        "--z0-max", "1000"])

    # NPZ carries the layer array, sorted ascending
    with np.load(sorted(glob.glob(str(graph_dir / "*.npz")))[0]) as f:
        assert "layer" in f.files
        assert (np.diff(f["layer"]) >= 0).all()

    trainer = train.main([
        "--input-dir", str(graph_dir), "--output-dir",
        str(tmp_path / "run_blocked"),
        "--n-samples", "6", "--batch-size", "2", "--n-epochs", "2",
        "--hidden-dim", "8", "--n-iters", "2",
        "--aggregation", "blocked", "--group", "2", "--bf16",
        "--lr-schedule", "cosine",
        "--valid-frac", "0.0", "--test-frac", "0.34"])
    assert len(trainer.train_losses) == 2
    assert np.isfinite(trainer.train_losses).all()
    assert os.path.exists(tmp_path / "run_blocked" / "model.npz")


def test_train_cli_partitioned_strategy(tmp_path):
    """--strategy partitioned: packed batches halo-partitioned over the
    8-device CPU mesh with pre-scanned pinned capacities."""
    from gnn_fpga_jax.cli import prepare_graphs, train

    data_dir = tmp_path / "raw"
    graph_dir = tmp_path / "graphs"
    data_dir.mkdir()
    write_trackml_events(data_dir, n_events=4, n_tracks=8, seed=3)
    prepare_graphs.main([
        "--input-dir", str(data_dir), "--output-dir", str(graph_dir),
        "--n-files", "4", "--pt-min", "1", "--n-phi-sectors", "1",
        "--phi-slope-max", "0.1", "--phi-slope-outer-max", "0.1",
        "--z0-max", "1000"])
    trainer = train.main([
        "--input-dir", str(graph_dir),
        "--n-samples", "4", "--batch-size", "2", "--n-epochs", "1",
        "--hidden-dim", "8", "--n-iters", "2",
        "--strategy", "partitioned", "--prefetch", "0",
        "--valid-frac", "0.0", "--test-frac", "0.5"])
    assert len(trainer.train_losses) == 1
    assert np.isfinite(trainer.train_losses).all()


def test_train_cli_dp_strategy(tmp_path):
    """--strategy dp shards the batch axis over all 8 CPU-mesh devices."""
    from gnn_fpga_jax.cli import prepare_graphs, train

    data_dir = tmp_path / "raw"
    graph_dir = tmp_path / "graphs"
    data_dir.mkdir()
    write_trackml_events(data_dir, n_events=16, n_tracks=5, seed=4)
    prepare_graphs.main([
        "--input-dir", str(data_dir), "--output-dir", str(graph_dir),
        "--n-files", "16", "--pt-min", "1", "--n-phi-sectors", "1",
        "--phi-slope-max", "0.1", "--phi-slope-outer-max", "0.1",
        "--z0-max", "1000"])
    trainer = train.main([
        "--input-dir", str(graph_dir),
        "--n-samples", "16", "--batch-size", "8", "--n-epochs", "1",
        "--hidden-dim", "8", "--n-iters", "2", "--strategy", "dp",
        "--valid-frac", "0.0", "--test-frac", "0.0"])
    assert len(trainer.train_losses) == 1
    assert np.isfinite(trainer.train_losses).all()


@pytest.mark.parametrize("agg", ["blocked", "dense"])
def test_train_cli_partitioned_rejects_one_hot_routes(tmp_path, agg):
    """--strategy partitioned aggregates with segment-sums only, so an
    explicit one-hot route is refused instead of silently ignored."""
    from gnn_fpga_jax.cli import train
    from gnn_fpga_jax.core.graph import save_npz
    from gnn_fpga_jax.data import toy2d

    g = toy2d.make_segment_graphs(toy2d.Toy2DConfig(n_layers=4,
                                                    n_tracks=3), 4)
    for i in range(4):
        save_npz(jax.tree.map(lambda a: a[i], g), str(tmp_path / f"{i}.npz"))
    with pytest.raises(ValueError, match="does not combine"):
        train.main(["--input-dir", str(tmp_path), "--batch-size", "2",
                    "--strategy", "partitioned", "--aggregation", agg,
                    "--valid-frac", "0.0", "--test-frac", "0.0"])
