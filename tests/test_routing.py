"""Aggregation auto-routing decisions: pin the layout
`aggregation="auto"` picks in each regime, and that the segment-sum
fallback above the one-hot limit WARNS instead of landing there
silently.  Regimes (see models/mpnn.py): dense below V*E ~ 8M; blocked
when blocks are attached; sparse otherwise."""

import warnings

import jax
import numpy as np
import pytest

from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.ops import blocked as blk


def _cfg(**kw):
    return mpnn.SegmentClassifierConfig(input_dim=2, hidden_dim=8,
                                        n_iters=2, **kw)


def _graph(n_tracks=4, batch=False):
    cfg = toy2d.Toy2DConfig(n_layers=6, n_tracks=n_tracks, seed=0)
    g = toy2d.make_segment_graphs(cfg, 2 if batch else 1)
    return (g if batch else jax.tree.map(lambda a: a[0], g)), cfg


def test_auto_picks_dense_at_sector_scale():
    g, _ = _graph()
    cfg = _cfg(aggregation="auto")
    assert mpnn._use_dense(cfg, g)
    assert not mpnn._use_blocked(cfg, g)


def test_auto_picks_blocked_when_blocks_attached():
    g, tcfg = _graph()
    g = blk.attach_blocks_layered(g, toy2d.layer_offsets(tcfg))
    cfg = _cfg(aggregation="auto")
    assert mpnn._use_blocked(cfg, g)


def test_auto_warns_on_slow_fallback_above_limit():
    """Above _DENSE_AUTO_LIMIT with no blocks attached, auto must not fall
    to the XLA segment-sum path silently."""
    g, _ = _graph(n_tracks=80)  # V=480, E=30400 -> V*E = 14.6M > 8M
    assert g.n_node * g.n_edge > mpnn._DENSE_AUTO_LIMIT
    cfg = _cfg(aggregation="auto")
    with pytest.warns(UserWarning, match="XLA segment-sum path"):
        assert not mppn_use_dense(cfg, g)


def mppn_use_dense(cfg, g):
    return mpnn._use_dense(cfg, g)


def test_explicit_choices_never_warn():
    g, _ = _graph(n_tracks=80)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not mpnn._use_dense(_cfg(aggregation="sparse"), g)
        assert mpnn._use_dense(_cfg(aggregation="dense"), g)
