"""Plotting utilities produce files without touching a display backend."""

import jax
import numpy as np

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.utils import plotting


def _one_graph():
    cfg = toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=0)
    batched = toy2d.make_segment_graphs(cfg, 1)
    return jax.tree.map(lambda a: a[0], batched), cfg


def test_draw_iterations_writes_png(tmp_path):
    g, _ = _one_graph()
    mcfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=4, n_iters=3)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(0), mcfg)
    _, es, _ = mpnn.segment_classifier_intermediates(params, g, mcfg)
    assert len(es) == 3
    out = tmp_path / "iters.png"
    plotting.draw_iterations(g, [np.asarray(e) for e in es],
                             filename=str(out))
    assert out.exists() and out.stat().st_size > 0


def test_plot_losses_and_weight_histograms(tmp_path):
    f1 = tmp_path / "loss.png"
    plotting.plot_losses([1.0, 0.5, 0.3], [0.9, 0.6, 0.4], filename=str(f1))
    assert f1.exists()
    mcfg = mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=4, n_iters=1)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(1), mcfg)
    f2 = tmp_path / "weights.png"
    plotting.plot_weight_histograms(params, filename=str(f2))
    assert f2.exists()


def test_plot_roc_returns_auc(tmp_path):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 500)
    p = np.clip(y * 0.6 + rng.uniform(0, 0.5, 500), 0, 1)
    f = tmp_path / "roc.png"
    _, auc = plotting.plot_roc(y, p, filename=str(f))
    assert f.exists()
    assert auc > 0.8


def test_exploration_plots(tmp_path):
    """ActsExplore1-style characterization plots render and save."""
    import numpy as np
    import pandas as pd
    from gnn_fpga_jax.data import exploration as ex
    from gnn_fpga_jax.utils import plotting

    rng = np.random.default_rng(8)
    hits = pd.DataFrame({
        "evtid": np.repeat(np.arange(4), 12),
        "barcode": np.tile(np.repeat(np.arange(3), 4), 4),
        "r": rng.uniform(30, 900, 48),
        "phi": rng.uniform(-np.pi, np.pi, 48),
        "z": rng.uniform(-200, 200, 48),
        "eta": rng.normal(0, 1, 48),
    })
    particles = pd.DataFrame({
        "evtid": np.repeat(np.arange(4), 3),
        "barcode": np.tile(np.arange(3), 4),
        "phi": rng.uniform(-np.pi, np.pi, 12),
        "eta": rng.normal(0, 1, 12),
    })
    plotting.plot_track_spans(ex.track_spans(hits),
                              filename=str(tmp_path / "spans.png"))
    plotting.plot_multiplicities(ex.multiplicities(hits, particles),
                                 filename=str(tmp_path / "mult.png"))
    plotting.plot_hit_particle_deltas(
        ex.hit_particle_deltas(hits, particles),
        filename=str(tmp_path / "dr.png"))
    for f in ("spans.png", "mult.png", "dr.png"):
        assert (tmp_path / f).stat().st_size > 0
