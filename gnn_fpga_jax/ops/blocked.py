"""Blocked (layered) incidence aggregation — exploit detector-layer structure.

Tracking graphs are *layered*: every candidate edge connects a hit on
layer ``l`` to a hit on layer ``l+1`` (the reference builds them exactly
so, one pandas join per adjacent layer pair —
`/root/reference/gnn/graph.py:68-93` ``construct_segments`` over
``layer_pairs``; same for the toy generator and the mu200 windows).  The
global incidence matrix ``R[v, e]`` is therefore **block-diagonal** when
edges are grouped by layer pair: an edge of pair ``(l, l+1)`` only
touches the nodes of layers ``l`` and ``l+1``.

The dense one-hot path (`ops/dense_incidence.py`) multiplies the full
``[V, E]`` one-hot regardless — at mu200-sector scale (V=440, E=5016,
19 layer pairs) ~90% of those FLOPs and of the incidence HBM reads are
structural zeros *between* blocks.  This module performs the same
gather/scatter contraction per block:

    global:   2 * V * E * D            FLOPs per bmm
    blocked:  2 * sum_b bn_b * be_b * D  ~= 2 * V/L * E * D  (L layers)

with ``[be, bn]`` one-hots that are ~L times smaller in HBM.  Each node
appears in at most two blocks (as the *send* layer of pair ``l`` and the
*receive* layer of pair ``l-1``); block-local results are reconciled to
the global node table with a one-hot broadcast matrix ``G`` (and its
transpose for the reduce) — also matmuls, so the whole path is dense
matmuls with no gather or scatter.  How it compares with dense and
sparse on the H100 is not yet measured (ROADMAP.md queue 1 item 3).

Scale limit: the broadcast/reduce one-hot ``G`` is ``[nB*bn, V]`` — on a
single PACKED graph at V~16k that is ~640MB, so large sectored workloads
ride blocked as a BATCH (each graph at sector V), and connected large
graphs route to sparse.

Plan construction is host-side numpy (`attach_blocks_layered`), fully
vectorised over the batch; the plan is index arrays only, so it stacks /
shards / vmaps like every other Graph leaf.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gnn_fpga_jax.core.graph import Graph


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockedPlan:
    """Per-graph block structure (leading batch dims allowed).

    ``block_nodes[b, i]`` is the global node id of slot ``i`` of block
    ``b`` (pad slots hold ``n_node``, whose one-hot row is all-zero).
    ``src_local/dst_local[b, j]`` are the *block-local* node slots of
    edge ``j`` of block ``b`` (pad edges hold ``bn`` — all-zero one-hot
    column).  The graph's edge arrays are permuted so that global edge
    index ``b * be + j`` is edge ``j`` of block ``b``.
    """

    block_nodes: jax.Array  # [..., nB, bn] int32, pad -> n_node
    src_local: jax.Array    # [..., nB, be] int32 in [0, bn), pad -> bn
    dst_local: jax.Array    # [..., nB, be] int32 in [0, bn), pad -> bn

    @property
    def n_blocks(self) -> int:
        return self.block_nodes.shape[-2]

    @property
    def block_n(self) -> int:
        return self.block_nodes.shape[-1]

    @property
    def block_e(self) -> int:
        return self.src_local.shape[-1]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def attach_blocks_layered(
    graph: Graph,
    layer_offsets,
    group: int = 1,
    block_e: int | None = None,
    block_n: int | None = None,
) -> Graph:
    """Permute a layered graph's edges into per-layer-pair blocks and
    attach a :class:`BlockedPlan` for the blocked aggregation path.

    Args:
      graph: batched ``[B, ...]`` or unbatched Graph whose nodes are
        sorted by detector layer and whose every real edge goes from a
        hit on layer ``l`` to one on layer ``l+1`` (the invariant all
        reference graph builders produce, `graph.py:68-93`).
      layer_offsets: int array ``[n_layers + 1]`` — nodes of layer ``l``
        occupy global ids ``[layer_offsets[l], layer_offsets[l+1])``.
        May also be ``[B, n_layers + 1]`` with one offset row per graph
        of the batch (real datasets: per-event layer populations differ,
        e.g. NPZ graphs carrying a per-node ``layer`` array — see
        `core.graph.layer_offsets_from_layers`).
      group: merge this many consecutive layer pairs per block.  Larger
        groups raise the one-hot contraction dim (bigger, fewer matmuls)
        at the cost of ~(group+1)/(2*group) more block FLOPs.
      block_e: static per-block edge capacity; default = max real count
        over the batch, rounded up to a multiple of 8.  Pass explicitly
        when building many stacks that must share one compiled shape.
      block_n: static per-block node capacity; default = max layer-range
        span over batch and blocks, rounded up to a multiple of 8.  Pin
        for shape-stable compilation across batches, like ``block_e``.

    Returns a new Graph with edge arrays reordered/padded to
    ``nB * block_e`` and ``graph.blocks`` set.  Node arrays unchanged.
    """
    off = np.asarray(layer_offsets, dtype=np.int64)
    n_layers = off.shape[-1] - 1
    n_pairs = n_layers - 1
    if n_pairs < 1:
        raise ValueError("need at least 2 layers")
    g = int(group)
    n_blocks = -(-n_pairs // g)

    batched = np.asarray(graph.senders).ndim > 1
    senders = np.asarray(graph.senders, dtype=np.int64)
    receivers = np.asarray(graph.receivers, dtype=np.int64)
    y = np.asarray(graph.y)
    emask = np.asarray(graph.edge_mask)
    if not batched:
        senders, receivers = senders[None], receivers[None]
        y, emask = y[None], emask[None]
    B, E = senders.shape
    if off.ndim == 1:
        off = np.broadcast_to(off, (B, n_layers + 1))
    elif off.shape[0] != B:
        raise ValueError(
            f"layer_offsets batch dim {off.shape[0]} != graph batch {B}")
    n_node = graph.n_node
    real = emask > 0

    # --- layer of each sender -> pair index -> block ---------------------
    # (vectorised per-row searchsorted: offsets are ascending per graph)
    pair = (senders[:, :, None] >= off[:, None, :]).sum(-1) - 1
    if np.any(pair[real] >= n_pairs) or np.any(pair[real] < 0):
        raise ValueError("sender layers out of range for layer_offsets")
    recv_layer = (receivers[:, :, None] >= off[:, None, :]).sum(-1) - 1
    if np.any(recv_layer[real] != pair[real] + 1):
        raise ValueError(
            "graph is not layered: every real edge must go from layer l "
            "to layer l+1 (nodes sorted by layer)")
    blk = np.where(real, pair // g, n_blocks)  # pad edges -> virtual block

    # --- stable bucketise edges into [nB, be] slots, batch-vectorised ----
    order = np.argsort(blk, axis=-1, kind="stable")          # [B, E]
    blk_s = np.take_along_axis(blk, order, axis=-1)
    rows = np.repeat(np.arange(B), E)
    counts = np.bincount(
        (rows * (n_blocks + 1) + blk_s.ravel()).astype(np.int64),
        minlength=B * (n_blocks + 1)).reshape(B, n_blocks + 1)
    starts = np.concatenate(
        [np.zeros((B, 1), np.int64), np.cumsum(counts, axis=-1)[:, :-1]],
        axis=-1)
    slot = np.arange(E)[None] - np.take_along_axis(starts, blk_s, axis=-1)
    max_be = int(slot[blk_s < n_blocks].max()) + 1 if real.any() else 0
    be = _round_up(max_be, 8) if block_e is None else int(block_e)
    if max_be > be:
        raise ValueError(f"block_e={be} < max real block size {max_be}")

    valid = blk_s < n_blocks
    dest = (blk_s * be + slot)[valid]
    brow = np.broadcast_to(np.arange(B)[:, None], (B, E))[valid]

    def scatter(src, fill, dtype):
        out = np.full((B, n_blocks * be), fill, dtype=dtype)
        out[brow, dest] = np.take_along_axis(src, order, axis=-1)[valid]
        return out

    new_s = scatter(senders, 0, np.int32)
    new_r = scatter(receivers, 0, np.int32)
    new_y = scatter(y, 0.0, y.dtype)
    new_m = scatter(emask, 0.0, emask.dtype)

    # --- block node slots: contiguous layer ranges (per graph) -----------
    lo_idx = np.arange(n_blocks) * g                          # [nB]
    hi_idx = np.minimum(lo_idx + g + 1, n_layers)
    lo = off[:, lo_idx]                                       # [B, nB]
    hi = off[:, hi_idx]                                       # [B, nB]
    bn = _round_up(int((hi - lo).max()), 8)
    if block_n is not None:
        if bn > block_n:
            raise ValueError(f"block_n={block_n} < max layer-range span {bn}")
        bn = int(block_n)
    slot_ids = lo[:, :, None] + np.arange(bn)[None, None, :]  # [B, nB, bn]
    block_nodes = np.where(slot_ids < hi[:, :, None], slot_ids,
                           n_node).astype(np.int32)

    # --- block-local endpoint slots (pad -> bn: zero one-hot column) -----
    base_of_slot = np.repeat(lo, be, axis=-1)                # [B, nB*be]
    m = new_m > 0
    src_local = np.where(m, new_s - base_of_slot, bn).astype(np.int32)
    dst_local = np.where(m, new_r - base_of_slot, bn).astype(np.int32)
    if np.any((src_local[m] < 0) | (src_local[m] >= bn)) or np.any(
            (dst_local[m] < 0) | (dst_local[m] >= bn)):
        raise ValueError("edge endpoints escape their block node range")

    plan = BlockedPlan(
        block_nodes=block_nodes,
        src_local=src_local.reshape(B, n_blocks, be),
        dst_local=dst_local.reshape(B, n_blocks, be),
    )
    if not batched:
        new_s, new_r = new_s[0], new_r[0]
        new_y, new_m = new_y[0], new_m[0]
        plan = BlockedPlan(
            block_nodes=plan.block_nodes[0],
            src_local=plan.src_local[0],
            dst_local=plan.dst_local[0])
    return graph.replace(
        senders=new_s, receivers=new_r, y=new_y, edge_mask=new_m,
        blocks=plan)


# ---------------------------------------------------------------------------
# Device-side blocked primitives (per graph; vmap for batches)
# ---------------------------------------------------------------------------

def broadcast_matrix(plan: BlockedPlan, n_node: int, dtype) -> jax.Array:
    """``G[s, v] = 1`` iff block slot ``s`` (flattened ``[nB*bn]``) holds
    global node ``v``; pad slots are all-zero rows.  ``G @ h`` broadcasts
    the node table into blocks, ``G.T @ m`` reduces block-local partials
    back (each node's contributions summed across its <=2 blocks)."""
    return jax.nn.one_hot(plan.block_nodes.reshape(-1), n_node, dtype=dtype)


def local_incidence(plan: BlockedPlan, edge_mask: jax.Array, dtype):
    """Block-local one-hots ``Ro[b, e, n] = 1`` iff edge ``e`` of block
    ``b`` starts at local slot ``n`` (``Ri`` for ends) — the blocked
    counterpart of `ops/dense_incidence.incidence`, ~n_layers x smaller."""
    em = edge_mask.reshape(plan.src_local.shape).astype(dtype)[..., None]
    ro = jax.nn.one_hot(plan.src_local, plan.block_n, dtype=dtype) * em
    ri = jax.nn.one_hot(plan.dst_local, plan.block_n, dtype=dtype) * em
    return ri, ro


def gather_blocks(g: jax.Array, h: jax.Array, n_blocks: int) -> jax.Array:
    """Broadcast the global node table into block layout: ``[nB, bn, D]``."""
    hb = jnp.einsum("sv,vf->sf", g, h.astype(g.dtype))
    return hb.reshape(n_blocks, -1, h.shape[-1])


def gather_bmm(r: jax.Array, hb: jax.Array) -> jax.Array:
    """``bo[b, e] = hb[b, src_local[b, e]]`` as a per-block matmul."""
    return jnp.einsum("ben,bnf->bef", r, hb)


def scatter_bmm(r: jax.Array, messages: jax.Array,
                weights: jax.Array | None = None) -> jax.Array:
    """Per-block matmul scatter-add of (optionally edge-weighted) messages."""
    if weights is not None:
        messages = messages * weights[..., None].astype(messages.dtype)
    return jnp.einsum("ben,bef->bnf", r, messages)


def reduce_blocks(g: jax.Array, mb: jax.Array) -> jax.Array:
    """Reduce block-local node partials ``[nB, bn, D]`` to the global
    node table ``[V, D]`` (transpose of :func:`broadcast_matrix`)."""
    return jnp.einsum("sv,sf->vf", g, mb.reshape(-1, mb.shape[-1]))
