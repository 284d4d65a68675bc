"""Toy2D synthetic tracking data — deterministic-geometry test fixture.

Vectorised re-design of the reference's toy generator
(`/root/reference/gnn/MPNN_Seg_Toy2D.ipynb:cell4,7,8,11,12` and
`GCN_Toy2D.ipynb:cell4,17`): straight tracks crossing ``n_layers`` 1-D
detector layers at radii ``det_r``; hits on each layer are sorted by
position.  Every toy event shares the same edge topology (all hit pairs on
adjacent layers), so graphs have naturally static shapes — ideal XLA food.

Used as: unit-test fixture (known ground truth), convergence benchmark
(reference test accuracy 0.986, `MPNN_Seg_Toy2D.ipynb:cell23`), and
synthetic stand-in for detector data in throughput benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_fpga_jax.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class Toy2DConfig:
    n_layers: int = 10
    n_tracks: int = 4
    det_r: Optional[np.ndarray] = None  # default: arange(n_layers)
    seed: int = 0

    def radii(self) -> np.ndarray:
        if self.det_r is not None:
            return np.asarray(self.det_r, dtype=np.float32)
        return np.arange(self.n_layers, dtype=np.float32)


def gen_tracks(rng: np.random.Generator, n: int, det_r: np.ndarray) -> np.ndarray:
    """n straight tracks: uniform entry/exit x in [0,1), linear in r.

    Returns hit x-coordinates with shape (n, n_layers)
    (`MPNN_Seg_Toy2D.ipynb:cell4` gen_tracks).
    """
    xin = rng.uniform(size=n).astype(np.float32)
    xout = rng.uniform(size=n).astype(np.float32)
    slopes = (xout - xin) / (det_r[-1] - det_r[0])
    return np.outer(slopes, det_r) + xin[:, None]


def generate_events(cfg: Toy2DConfig, n_events: int):
    """Generate toy events fully vectorised.

    Returns (x, y, r, l) each of shape (n_events, n_layers * n_tracks):
    hit position, track label, layer radius, layer index — hits sorted by
    position within each layer (`cell4` generate_data + `cell8` flattening).
    """
    rng = np.random.default_rng(cfg.seed)
    det_r = cfg.radii()
    nl, nt = cfg.n_layers, cfg.n_tracks
    # (n_events, n_tracks, n_layers)
    tracks = np.stack(
        [gen_tracks(rng, n_events, det_r) for _ in range(nt)], axis=1
    )
    # Sort hits within each layer by position; argsort index = track label.
    idx = np.argsort(tracks, axis=1)
    i0 = np.arange(n_events)[:, None, None]
    i2 = np.arange(nl)[None, None, :]
    x = tracks[i0, idx, i2]                     # (ev, hit_in_layer, layer)
    y = idx.astype(np.float32)
    # to (ev, layer, hit) then flatten layers*hits
    x = x.transpose(0, 2, 1).reshape(n_events, -1).astype(np.float32)
    y = y.transpose(0, 2, 1).reshape(n_events, -1)
    r = np.broadcast_to(np.repeat(det_r, nt)[None, :], x.shape).astype(np.float32)
    l = np.broadcast_to(np.repeat(np.arange(nl), nt)[None, :], x.shape)
    return x, y, r, l.astype(np.int32)


def layer_offsets(cfg: Toy2DConfig) -> np.ndarray:
    """Node-id boundaries of each detector layer: nodes of layer ``l``
    occupy ids ``[offsets[l], offsets[l+1])``.

    Toy graphs are layer-major by construction (`generate_events` flattens
    (layer, hit)), so the offsets are exact — this is the input
    `ops/blocked.attach_blocks_layered` needs to exploit the
    block-diagonal incidence structure.
    """
    return (np.arange(cfg.n_layers + 1) * cfg.n_tracks).astype(np.int64)


def toy_edges(cfg: Toy2DConfig):
    """The shared COO edge list: every hit pair on adjacent layers.

    (senders, receivers) with senders on layer k, receivers on layer k+1 —
    the shared ``Ri/Ro`` of `MPNN_Seg_Toy2D.ipynb:cell11`, kept sparse.
    """
    nl, nt = cfg.n_layers, cfg.n_tracks
    hit_idx = np.arange(nl * nt).reshape(nl, nt)
    senders, receivers = [], []
    for k in range(nl - 1):
        s, r = np.meshgrid(hit_idx[k], hit_idx[k + 1], indexing="ij")
        senders.append(s.ravel())
        receivers.append(r.ravel())
    return (np.concatenate(senders).astype(np.int32),
            np.concatenate(receivers).astype(np.int32))


def make_segment_graphs(cfg: Toy2DConfig, n_events: int) -> Graph:
    """Batched Graph for the segment-classification task.

    Node features [x, r/r_max]; edge label = same track on both endpoints
    (`cell12`: ``ey = (yi == yo)``).  Returns a batched Graph with leading
    axis ``n_events`` and no padding (toy graphs are already static-shape).

    The radius feature is scaled to [0, 1] — the reference's
    ``feature_scale`` normalisation (`prepareGraphs.py:149-150`); without it
    the tanh input layer saturates on deep-detector configs and training
    flatlines at the base rate.
    """
    x, y, r, _ = generate_events(cfg, n_events)
    senders, receivers = toy_edges(cfg)
    n_edge = len(senders)
    feats = np.stack([x, r / max(r.max(), 1e-9)], axis=-1)   # (ev, N, 2)
    ey = (y[:, senders] == y[:, receivers]).astype(np.float32)
    n_node = cfg.n_layers * cfg.n_tracks
    return Graph(
        x=feats,
        senders=np.broadcast_to(senders[None], (n_events, n_edge)).copy(),
        receivers=np.broadcast_to(receivers[None], (n_events, n_edge)).copy(),
        y=ey,
        node_mask=np.ones((n_events, n_node), np.float32),
        edge_mask=np.ones((n_events, n_edge), np.float32),
    )


def make_knn_segment_graphs(cfg: Toy2DConfig, n_events: int,
                            k: int = 12) -> Graph:
    """Segment graphs with **windowed** candidate edges: each hit on layer
    ``l+1`` connects to its ``k`` nearest (in x) hits on layer ``l``.

    This mirrors what the real pipelines do — the reference never feeds
    all adjacent-layer pairs at high pileup; it preselects doublets with
    geometric windows (`/root/reference/gnn/prepareGraphs.py:101-134`
    phi-slope/z0 cuts, `GraphConstructionDev_mu200.ipynb` dphi/dz cuts),
    keeping ~90-97% of true segments at ~10 candidates per hit.  The
    k-NN window gives the same sparsity with *static shapes*: exactly
    ``(n_layers-1) * n_tracks * k`` edges per event, every event.

    At high track density the all-pairs variant (:func:`make_segment_graphs`)
    is dominated by geometrically plausible fakes (1:n_tracks imbalance)
    — the regime where the reference's own mu200 training collapses to
    the base rate (recall 0.042, `MPNN_Seg_ACTS_mu200.ipynb:cell26`).
    Windowed candidates + ``TrainConfig.pos_weight`` is the learnable
    counterpart at the same graph size.

    Per-event edge lists differ (data-dependent neighbours), which the
    batched :class:`Graph` carries natively; shapes stay static.
    """
    x, y, r, _ = generate_events(cfg, n_events)
    nl, nt = cfg.n_layers, cfg.n_tracks
    kk = min(k, nt)
    xg = x.reshape(n_events, nl, nt)
    senders, receivers = [], []
    for layer in range(nl - 1):
        # (ev, receiver-hit, sender-hit) |dx|; k smallest per receiver
        dx = np.abs(xg[:, layer + 1, :, None] - xg[:, layer, None, :])
        idx = np.argpartition(dx, kk - 1, axis=-1)[..., :kk]
        s = layer * nt + idx
        rcv = np.broadcast_to(
            ((layer + 1) * nt + np.arange(nt))[None, :, None], s.shape)
        senders.append(s.reshape(n_events, -1))
        receivers.append(rcv.reshape(n_events, -1))
    senders = np.concatenate(senders, axis=1).astype(np.int32)
    receivers = np.concatenate(receivers, axis=1).astype(np.int32)
    ev = np.arange(n_events)[:, None]
    ey = (y[ev, senders] == y[ev, receivers]).astype(np.float32)
    feats = np.stack([x, r / max(r.max(), 1e-9)], axis=-1)
    n_node = nl * nt
    return Graph(
        x=feats, senders=senders, receivers=receivers, y=ey,
        node_mask=np.ones((n_events, n_node), np.float32),
        edge_mask=np.ones(senders.shape, np.float32),
    )


def make_window_segment_graphs(cfg: Toy2DConfig, n_events: int,
                               window: Optional[float] = None) -> Graph:
    """Segment graphs with **two-coordinate geometric window cuts** — the
    reference's own full-event construction style
    (`/root/reference/gnn/MPNN_Seg_ACTS_fullEvents.ipynb:cell8`: a dense
    adjacency *mask* from ``dphi_max`` AND ``dz_max`` cuts, not pandas
    joins; same spirit as the `prepareGraphs.py:37-40` phi-slope/z0 cuts).

    Tracks here are straight lines in TWO transverse coordinates (x, z),
    both linear in the layer radius — the toy analog of the detector's
    (phi, z).  Node features are ``[x, z, r/r_max]`` (three features, like
    the reference's ``[r, phi, z]``, `prepareGraphs.py:149`).

    Static-shape realisation: the edge list is the all-pairs
    :func:`toy_edges` topology and the cut lives in ``edge_mask`` —
    exactly the reference's dense-mask trick.  An edge (hit on layer
    ``l`` → hit on layer ``l+1``) survives iff ``|dx| < window`` AND
    ``|dz| < window``.  Toy tracks have ``|slope| < 1/(r_last - r_0)``
    per coordinate, so the default ``window = dr_adjacent / (r_last -
    r_0)`` keeps **100% of true segments** (the reference's cuts keep
    ~90-97%, `GraphConstructionDev.ipynb:cell42`) while the AND of two
    windows cuts almost every fake: a fake needs two tracks nearby in
    BOTH coordinates at once.  This is exactly why the reference reaches
    0.995 accuracy on its windowed full-event graphs
    (`MPNN_Seg_ACTS_fullEvents.ipynb:cell45`) but only 0.812 / recall
    0.042 on raw mu200 (`MPNN_Seg_ACTS_mu200.ipynb:cell26`) — and why a
    single-coordinate toy cannot get there: in 1-D, track *crossings*
    make the swap-fake geometrically identical to the true segment
    (that regime is :func:`make_knn_segment_graphs`, every fake a
    near-neighbour).  The executable evidence lives in
    `tests/test_reference_scale.py::test_full_event_window_metrics`.
    """
    rng = np.random.default_rng(cfg.seed)
    det_r = cfg.radii()
    nl, nt = cfg.n_layers, cfg.n_tracks
    # two independent straight-line coordinates per track (ev, track, layer)
    tx = np.stack([gen_tracks(rng, n_events, det_r) for _ in range(nt)],
                  axis=1)
    tz = np.stack([gen_tracks(rng, n_events, det_r) for _ in range(nt)],
                  axis=1)
    # sort hits within each layer by x; z rides along, argsort idx = track
    idx = np.argsort(tx, axis=1)
    i0 = np.arange(n_events)[:, None, None]
    i2 = np.arange(nl)[None, None, :]
    x = tx[i0, idx, i2].transpose(0, 2, 1).reshape(n_events, -1)
    z = tz[i0, idx, i2].transpose(0, 2, 1).reshape(n_events, -1)
    y = idx.transpose(0, 2, 1).reshape(n_events, -1)
    r = np.broadcast_to(np.repeat(det_r, nt)[None, :], x.shape)

    senders, receivers = toy_edges(cfg)
    if window is None:
        dr_adj = float(np.diff(det_r).max()) if nl > 1 else 1.0
        window = dr_adj / max(float(det_r[-1] - det_r[0]), 1e-9)
    n_edge = len(senders)
    feats = np.stack([x, z, r / max(r.max(), 1e-9)], axis=-1
                     ).astype(np.float32)
    dx = np.abs(x[:, receivers] - x[:, senders])
    dz = np.abs(z[:, receivers] - z[:, senders])
    edge_mask = ((dx < window) & (dz < window)).astype(np.float32)
    ey = ((y[:, senders] == y[:, receivers]) & (edge_mask > 0)
          ).astype(np.float32)
    n_node = nl * nt
    return Graph(
        x=feats,
        senders=np.broadcast_to(senders[None], (n_events, n_edge)).copy(),
        receivers=np.broadcast_to(receivers[None], (n_events, n_edge)).copy(),
        y=ey,
        node_mask=np.ones((n_events, n_node), np.float32),
        edge_mask=edge_mask,
    )


def make_gcn_data(cfg: Toy2DConfig, n_events: int, seed_layers: int = 3,
                  norm: str = "row"):
    """Dense-adjacency GCN task data (`GCN_Toy2D.ipynb:cell4,11`).

    Returns (X, A, y0): node features [x, r/r_max, seed], normalised
    adjacency ('row' or 'kw'), and the track-0 node labels.  The adjacency
    uses the entry/exit line constraints of the notebook's
    ``calc_adjacency``.
    """
    from gnn_fpga_jax.models import gcn

    x, y, r, l = generate_events(cfg, n_events)
    y0 = (y == 0).astype(np.float32)
    seed = np.where(l < seed_layers, y0, 0.0).astype(np.float32)
    feats = np.stack([x, r / r.max(), seed], axis=-1)
    adj, _ = gcn.toy_adjacency(x, r, l, y)
    if norm == "row":
        a = gcn.row_norm_adjacency(adj)
    elif norm == "kw":
        a = gcn.kipf_welling_adjacency(adj)
    else:
        raise ValueError(f"unknown adjacency norm {norm!r}")
    return feats, a, y0


def make_segment_gcn_data(cfg: Toy2DConfig, n_events: int,
                          sigma: float = 0.01):
    """Dual-graph (line-graph) segment-classification data
    (`GCN_Seg_Toy2D.ipynb:cell8-15`): segments as nodes, adjacency from
    shared middle hits weighted by the gaussian slope kernel.

    Returns (seg_features, seg_A, seg_y) with
    seg_features = [slope, r_mid/r_max].
    """
    from gnn_fpga_jax.models import gcn

    x, y, r, l = generate_events(cfg, n_events)
    hit_adj = gcn.layer_adjacency(l)
    seg_idx = gcn.segment_indices(hit_adj)
    seg_adj = gcn.segment_adjacency(seg_idx)
    slopes = gcn.segment_slopes(x, r, seg_idx)
    kernel = gcn.gaussian_slope_kernel(slopes, sigma)
    a = gcn.row_norm_adjacency(seg_adj * kernel)
    seg_y = gcn.segment_labels(y, seg_idx)
    ev = np.arange(n_events)[:, None, None]
    r_mid = r[ev, seg_idx].mean(axis=-1)
    feats = np.stack([slopes, r_mid / r.max()], axis=-1).astype(np.float32)
    return feats, a, seg_y


def make_hit_grids(cfg: Toy2DConfig, n_events: int):
    """Sorted hit-position grids for the image-style baseline models.

    Returns ``(grids, pids)``: hit x-positions per (layer, slot) sorted by
    position within each layer, shape (n_events, n_layers, n_tracks), and
    the track id occupying each slot (the `transform_hits` of
    `HitClustering_Toy2D.ipynb:cell3` / `Graph_dev.ipynb:cell4`).
    """
    x, y, _, _ = generate_events(cfg, n_events)
    nl, nt = cfg.n_layers, cfg.n_tracks
    return (x.reshape(n_events, nl, nt),
            y.reshape(n_events, nl, nt).astype(np.int32))


def make_segmenter_data(cfg: Toy2DConfig, n_events: int):
    """Hit-clustering segmenter task (`HitClustering_Toy2D.ipynb:cell14`).

    Input: hit grid (n_events, n_layers, n_tracks).  Target: for every hit
    on layer l, a one-hot distribution over layer-(l+1) slots marking the
    same-track hit — shape (n_events, (n_layers-1)*n_tracks, n_tracks).
    """
    grids, pids = make_hit_grids(cfg, n_events)
    assoc = (pids[:, :-1, :, None] == pids[:, 1:, None, :]).astype(np.float32)
    return grids, assoc.reshape(n_events, -1, cfg.n_tracks)


def make_seeded_grid_data(cfg: Toy2DConfig, n_events: int,
                          seed_size: int = 3, track: int = 0):
    """Seeded track-finding-as-image task (`Graph_dev.ipynb:cell9,21`).

    Returns ``(grids, seeds, targets)``: hit grids (n_events, L, T), the
    target track's slot one-hots on the first ``seed_size`` layers
    (n_events, seed_size, T), and the per-layer slot one-hot of the target
    track (n_events, L, T).
    """
    grids, pids = make_hit_grids(cfg, n_events)
    target = (pids == track).astype(np.float32)
    return grids, target[:, :seed_size].copy(), target


def make_seeded_node_graphs(cfg: Toy2DConfig, n_events: int, seed_layers: int = 3) -> Graph:
    """Batched Graph for the seeded hit-classification task (GCN workload).

    Node features [x, r/r_max, seed] where seed marks the target track's
    hits on the first ``seed_layers`` layers; node label = hit belongs to
    track 0 (`GCN_Toy2D.ipynb:cell17`).
    """
    x, y, r, l = generate_events(cfg, n_events)
    senders, receivers = toy_edges(cfg)
    n_edge = len(senders)
    y0 = (y == 0).astype(np.float32)
    seed = np.where(l < seed_layers, y0, 0.0).astype(np.float32)
    feats = np.stack([x, r / r.max(), seed], axis=-1)
    ey = (y[:, senders] == y[:, receivers]).astype(np.float32)
    n_node = cfg.n_layers * cfg.n_tracks
    return Graph(
        x=feats,
        senders=np.broadcast_to(senders[None], (n_events, n_edge)).copy(),
        receivers=np.broadcast_to(receivers[None], (n_events, n_edge)).copy(),
        y=ey,
        node_mask=np.ones((n_events, n_node), np.float32),
        edge_mask=np.ones((n_events, n_edge), np.float32),
        node_y=y0,
    )
