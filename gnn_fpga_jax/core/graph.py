"""Core graph data structures: COO edge-list graphs as JAX pytrees.

The reference (`/root/reference/gnn/graph.py:18-35`) represents a hit graph as
dense incidence matrices ``Ri/Ro`` of shape ``(n_nodes, n_edges)`` (``Ri`` maps
hits onto incoming edges / segment *ends*, ``Ro`` onto outgoing edges /
segment *starts*) plus a ``SparseGraph`` namedtuple holding the COO indices of
those matrices for NPZ storage.

The COO form *is* the stored and batched representation (the dense and
blocked aggregation routes build their one-hot incidences on the device,
per batch):

- ``senders[e]``    = the node index the edge leaves from   (== Ro row index)
- ``receivers[e]``  = the node index the edge arrives at    (== Ri row index)

Gathers (``x[senders]``) replace ``bmm(Ro^T, X)`` and segment-sums replace
``bmm(Ri*e, ...)`` — see `gnn_fpga_jax/ops/segment.py`.

Graphs are padded to static shapes for XLA:  padded edges have
``edge_mask == 0`` and point at the *pad node* (the first padded node slot,
whose features are zero), so a masked gather reproduces
exactly the all-zero rows that the reference's zero-padded dense ``Ri/Ro``
produce (`/root/reference/gnn/trainSegmentClassifier.py:66-95`
``merge_graphs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly padded, possibly batched) COO hit graph.

    All fields may carry an arbitrary number of leading batch dimensions; the
    per-graph shapes are ``x: [N, F]``, ``senders/receivers: [E]``,
    ``y: [E]``, ``node_mask: [N]``, ``edge_mask: [E]``.

    ``y`` holds the *edge* labels (segment truth, `graph.py:137-139` in the
    reference).  ``node_y`` optionally holds node labels for the hit
    classifier workload (`MPNN_HitClassifier.ipynb`).
    """

    x: jax.Array          # [..., N, F] float node features
    senders: jax.Array    # [..., E] int32 — edge start node (Ro)
    receivers: jax.Array  # [..., E] int32 — edge end node (Ri)
    y: jax.Array          # [..., E] float edge labels
    node_mask: jax.Array  # [..., N] float {0,1}
    edge_mask: jax.Array  # [..., E] float {0,1}
    node_y: Optional[jax.Array] = None  # [..., N] float node labels
    # Optional blocked (layered) aggregation plan exploiting the
    # block-diagonal incidence of layered tracking graphs; attach with
    # :func:`gnn_fpga_jax.ops.blocked.attach_blocks_layered` (batched ok).
    blocks: Optional[object] = None

    @property
    def n_node(self) -> int:
        return self.x.shape[-2]

    @property
    def n_edge(self) -> int:
        return self.senders.shape[-1]

    @property
    def n_feature(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)


def from_coo(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    y: np.ndarray,
    node_y: Optional[np.ndarray] = None,
) -> Graph:
    """Build an unpadded Graph from raw COO arrays (all real, masks = 1)."""
    x = np.asarray(x, dtype=np.float32)
    n_node, _ = x.shape
    n_edge = len(senders)
    g = Graph(
        x=x,
        senders=np.asarray(senders, dtype=np.int32),
        receivers=np.asarray(receivers, dtype=np.int32),
        y=np.asarray(y, dtype=np.float32),
        node_mask=np.ones((n_node,), dtype=np.float32),
        edge_mask=np.ones((n_edge,), dtype=np.float32),
        node_y=None if node_y is None else np.asarray(node_y, dtype=np.float32),
    )
    return g


def pad_graph(g: Graph, n_node: int, n_edge: int) -> Graph:
    """Pad a single graph to static (n_node, n_edge).

    Padded edges point at the FIRST pad-node slot (``g.n_node``) **only
    if** a pad slot exists; otherwise they point at node 0 but are masked.
    To keep parity with the reference's zero rows we always reserve at
    least one pad node: callers should pass ``n_node >= g.n_node + 1``
    when ``n_edge > g.n_edge``.
    """
    rn, re = int(g.x.shape[0]), int(g.senders.shape[0])
    if rn > n_node or re > n_edge:
        raise ValueError(
            f"graph ({rn} nodes, {re} edges) exceeds pad target "
            f"({n_node}, {n_edge})"
        )
    pad_node_idx = rn if n_node > rn else 0

    def _pad(a, total, fill=0.0):
        a = np.asarray(a)
        widths = [(0, total - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    return Graph(
        x=_pad(g.x, n_node).astype(np.float32),
        senders=_pad(g.senders, n_edge, pad_node_idx).astype(np.int32),
        receivers=_pad(g.receivers, n_edge, pad_node_idx).astype(np.int32),
        y=_pad(g.y, n_edge).astype(np.float32),
        node_mask=_pad(np.asarray(g.node_mask), n_node).astype(np.float32),
        edge_mask=_pad(np.asarray(g.edge_mask), n_edge).astype(np.float32),
        node_y=None if g.node_y is None else _pad(g.node_y, n_node).astype(np.float32),
    )


def batch_graphs(graphs, n_node: Optional[int] = None, n_edge: Optional[int] = None) -> Graph:
    """Stack graphs into a batched Graph with a leading batch axis.

    The static-shape replacement for the reference's ``merge_graphs``
    pad-to-batch-max (`trainSegmentClassifier.py:66-95`): every graph is
    padded to the same static (n_node, n_edge) and stacked; models vmap
    over the leading axis.
    """
    if n_node is None:
        n_node = max(int(g.x.shape[0]) for g in graphs) + 1
    if n_edge is None:
        n_edge = max(int(g.senders.shape[0]) for g in graphs)
    padded = [pad_graph(g, n_node, n_edge) for g in graphs]
    has_node_y = all(p.node_y is not None for p in padded)
    return Graph(
        x=np.stack([p.x for p in padded]),
        senders=np.stack([p.senders for p in padded]),
        receivers=np.stack([p.receivers for p in padded]),
        y=np.stack([p.y for p in padded]),
        node_mask=np.stack([p.node_mask for p in padded]),
        edge_mask=np.stack([p.edge_mask for p in padded]),
        node_y=np.stack([p.node_y for p in padded]) if has_node_y else None,
    )


def pack_graphs(graphs, n_node: Optional[int] = None, n_edge: Optional[int] = None) -> Graph:
    """Concatenate graphs into ONE flat packed graph (jraph-style).

    Senders/receivers are offset by each graph's node start, so a single
    segment-sum aggregates the whole batch (one big kernel launch instead
    of vmapped small ones).
    """
    xs, ss, rs, ys, nys, nms, ems = [], [], [], [], [], [], []
    offset = 0
    for g in graphs:
        xs.append(np.asarray(g.x))
        ss.append(np.asarray(g.senders) + offset)
        rs.append(np.asarray(g.receivers) + offset)
        ys.append(np.asarray(g.y))
        nms.append(np.asarray(g.node_mask))
        ems.append(np.asarray(g.edge_mask))
        if g.node_y is not None:
            nys.append(np.asarray(g.node_y))
        offset += int(g.x.shape[0])
    flat = from_coo(
        np.concatenate(xs),
        np.concatenate(ss),
        np.concatenate(rs),
        np.concatenate(ys),
        node_y=np.concatenate(nys) if len(nys) == len(graphs) else None,
    )
    # carry the inputs' padding masks (inputs may be pre-padded, e.g. to
    # tile-align each component of the pack)
    flat = flat.replace(node_mask=np.concatenate(nms).astype(np.float32),
                        edge_mask=np.concatenate(ems).astype(np.float32))
    if n_node is not None or n_edge is not None:
        tot_n = n_node if n_node is not None else int(flat.x.shape[0]) + 1
        tot_e = n_edge if n_edge is not None else int(flat.senders.shape[0])
        flat = pad_graph(flat, tot_n, tot_e)
    return flat


def unbatch_graphs(g: Graph) -> list:
    """Split a batched Graph (leading batch axis) into a list of single
    graphs.  Inverse of :func:`batch_graphs`; padding/masks are preserved
    per graph."""
    if np.asarray(g.x).ndim != 3:
        raise ValueError("unbatch_graphs expects a batched Graph [B, N, F]")
    n = int(np.asarray(g.x).shape[0])
    return [jax.tree.map(lambda a: a[i], g) for i in range(n)]


def layer_offsets_from_layers(layers, n_layers: Optional[int] = None) -> np.ndarray:
    """Per-node detector-layer array (ascending) -> ``layer_offsets``
    ``[n_layers + 1]`` for :func:`gnn_fpga_jax.ops.blocked.attach_blocks_layered`.

    ``layers`` covers the graph's REAL nodes (the per-node ``layer`` key
    the prepare CLIs write into NPZ archives).  Pad nodes (appended past
    the real nodes by batching) sit outside every layer range; no real
    edge can reach them, so the blocked plan never maps them.
    """
    layers = np.asarray(layers)
    if layers.ndim != 1:
        raise ValueError("layers must be a per-node 1-D array")
    if np.any(np.diff(layers) < 0):
        raise ValueError(
            "nodes must be sorted by layer for the blocked path "
            "(prepare CLIs sort hits by layer before graph construction)")
    if n_layers is None:
        n_layers = int(layers.max()) + 1
    off = np.searchsorted(layers, np.arange(n_layers + 1),
                          side="left").astype(np.int64)
    off[-1] = len(layers)
    return off


# ---------------------------------------------------------------------------
# Dense incidence-matrix conversion (reference interchange + test oracle)
# ---------------------------------------------------------------------------

def to_dense_incidence(g: Graph):
    """Return (X, Ri, Ro, y) dense arrays as in the reference's ``Graph``
    namedtuple (`graph.py:18`, `graph_from_sparse` `graph.py:28-35`).

    ``Ri[receivers[e], e] = 1`` and ``Ro[senders[e], e] = 1``; padded edges
    (edge_mask == 0) produce all-zero columns, matching ``merge_graphs``.
    """
    n, e = g.n_node, g.n_edge
    x = np.asarray(g.x)
    ri = np.zeros((n, e), dtype=np.float32)
    ro = np.zeros((n, e), dtype=np.float32)
    em = np.asarray(g.edge_mask) > 0
    cols = np.arange(e)[em]
    ri[np.asarray(g.receivers)[em], cols] = 1
    ro[np.asarray(g.senders)[em], cols] = 1
    return x, ri, ro, np.asarray(g.y)


def from_dense_incidence(x, ri, ro, y, node_y=None) -> Graph:
    """Inverse of :func:`to_dense_incidence` for reference-format graphs."""
    ri = np.asarray(ri)
    ro = np.asarray(ro)
    n_edge = ri.shape[1]
    receivers = np.argmax(ri, axis=0)
    senders = np.argmax(ro, axis=0)
    # Columns that are entirely zero are padding.
    edge_mask = (ri.sum(axis=0) > 0).astype(np.float32)
    g = from_coo(x, senders, receivers, y, node_y=node_y)
    return g.replace(edge_mask=edge_mask * np.asarray(g.edge_mask))


# ---------------------------------------------------------------------------
# NPZ I/O — file-compatible with the reference's SparseGraph archives
# ---------------------------------------------------------------------------

_SPARSE_KEYS = ("X", "Ri_rows", "Ri_cols", "Ro_rows", "Ro_cols", "y",
                "node_y")


def save_npz(g: Graph, filename, **extra) -> None:
    """Write a graph as a reference-compatible SparseGraph NPZ
    (`graph.py:179-186`): keys X, Ri_rows, Ri_cols, Ro_rows, Ro_cols, y.

    Only the real (unmasked) part is written.  ``extra`` lets callers append
    per-graph properties (pt, eta) as the muon pipeline does
    (`Muon_graph.py:198-205`).
    """
    em = np.asarray(g.edge_mask) > 0
    nm = np.asarray(g.node_mask) > 0
    cols = np.arange(int(em.sum()), dtype=np.int64)
    arrays = dict(
        X=np.asarray(g.x)[nm],
        Ri_rows=np.asarray(g.receivers)[em].astype(np.int64),
        Ri_cols=cols,
        Ro_rows=np.asarray(g.senders)[em].astype(np.int64),
        Ro_cols=cols,
        y=np.asarray(g.y)[em],
    )
    if g.node_y is not None:
        # Extension key (absent in reference archives): node labels for
        # the hit-classifier workload (`MPNN_HitClassifier.ipynb`).
        arrays["node_y"] = np.asarray(g.node_y)[nm]
    np.savez(filename, **arrays, **extra)


def load_npz(filename) -> Graph:
    """Load a reference SparseGraph NPZ into a COO :class:`Graph`.

    Handles the general case where Ri_cols/Ro_cols are not sorted ranges by
    scattering rows into per-edge slots first.
    """
    with np.load(filename) as f:
        data = {k: f[k] for k in f.files}
    x = data["X"]
    y = data["y"]
    n_edge = len(y)
    receivers = np.zeros(n_edge, dtype=np.int32)
    senders = np.zeros(n_edge, dtype=np.int32)
    receivers[data["Ri_cols"].astype(np.int64)] = data["Ri_rows"].astype(np.int32)
    senders[data["Ro_cols"].astype(np.int64)] = data["Ro_rows"].astype(np.int32)
    return from_coo(x, senders, receivers, y, node_y=data.get("node_y"))


def load_npz_with_extras(filename):
    """Like :func:`load_npz` but also returns non-graph keys (pt, eta, ...)."""
    with np.load(filename) as f:
        data = {k: f[k] for k in f.files}
    g = load_npz(filename)
    extras = {k: v for k, v in data.items() if k not in _SPARSE_KEYS}
    return g, extras
