"""Graph (context) parallelism: one large graph partitioned across chips.

The scaling axis the reference struggles with is graph size at high pileup
(SURVEY.md §5: mu200 events forced batch=2, `MPNN_Seg_ACTS_mu200.ipynb`);
its escape hatches are sectoring and subsampling.  Here a single large
graph is *row-partitioned* across the mesh ``graph`` axis:

- nodes are split into contiguous ranges, one per device;
- every edge is owned by the device owning its **receiver** (edges sorted
  by receiver in preprocessing), so the receiver-side aggregation
  ``mi = Σ_{e→n} e·h[send]`` is a purely local segment-sum;
- per message-passing iteration only **boundary (halo) rows** move: each
  shard pre-computes which remote node rows its edges reference
  (``need[p][q]``, host-side, once per topology), pulls exactly those via
  one ``all_to_all``, gathers edges from the local+halo extended table,
  and pushes the sender-side partials for halo rows back to their owners
  via the reverse ``all_to_all`` + scatter-add.

Communication per iteration: two all-to-alls of ``[P*S, D]`` where ``S``
is the (padded) max halo size per shard pair — O(boundary·D), not
O(N·D); per-device activation memory is ``[N/P + P*S, D]`` and shrinks
~P-fold with good partitions (SURVEY.md §5 "boundary-node feature
all-to-all overlapped with local segment-sum").  Both collectives run
inside ``shard_map``.  ``exchange="allgather"`` keeps the
full-replication fallback for irregular graphs whose halos approach N.
No reference counterpart exists (`SURVEY.md §2.3`); this is new
capability.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnn_fpga_jax.core.graph import Graph
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.parallel import mesh as mesh_lib


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A graph split into P receiver-owned shards, stacked on axis 0.

    Shapes (per shard, stacked leading P):
      x:           [P, N_local, F]   node features of owned nodes
      senders:     [P, E_local]      GLOBAL sender ids
      receivers:   [P, E_local]      LOCAL receiver ids (0.. N_local-1)
      y:           [P, E_local]      edge labels
      edge_mask:   [P, E_local]
      node_mask:   [P, N_local]
      senders_ext: [P, E_local]      sender index into the local+halo
                                     extended table [N_local + P*S rows]
      send_idx:    [P, P*S]          local row indices this shard sends;
                                     block q (size S) = rows destined to
                                     (and whose mo-partials return from)
                                     shard q
    """

    x: jax.Array
    senders: jax.Array
    receivers: jax.Array
    y: jax.Array
    edge_mask: jax.Array
    node_mask: jax.Array
    senders_ext: Optional[jax.Array] = None
    send_idx: Optional[jax.Array] = None
    node_y: Optional[jax.Array] = None  # [P, N_local] hit-classifier labels

    @property
    def n_parts(self) -> int:
        return self.x.shape[0]

    @property
    def n_local(self) -> int:
        return self.x.shape[1]

    @property
    def n_global(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    @property
    def halo_size(self) -> int:
        """Per-pair halo row count S (padded, static)."""
        return self.send_idx.shape[-1] // self.n_parts


def partition_graph(g: Graph, n_parts: int,
                    edge_capacity: Optional[int] = None,
                    halo_capacity: Optional[int] = None) -> PartitionedGraph:
    """Split one (unbatched, possibly padded) graph into receiver-owned
    shards (host-side numpy; one-time preprocessing per graph).

    Nodes are padded to a multiple of ``n_parts`` (pad rows masked).  Each
    shard's edges are those whose receiver falls in its node range, padded
    to the max shard edge count; pad edges point at the shard's last local
    node and are masked.

    ``edge_capacity`` / ``halo_capacity`` pin the static per-shard edge
    count and per-pair halo size S: partitioned shapes are data-dependent,
    so a stream of per-batch partitions recompiles the train step on
    every new maximum — pre-scan the dataset for its worst case and pin
    both to keep one compiled shape (the train CLI does this).
    """
    x = np.asarray(g.x)
    senders = np.asarray(g.senders)
    receivers = np.asarray(g.receivers)
    y = np.asarray(g.y)
    em = np.asarray(g.edge_mask)
    nm = np.asarray(g.node_mask)

    n = x.shape[0]
    n_local = -(-n // n_parts)
    n_pad = n_local * n_parts
    if n_pad > n:
        pad = n_pad - n
        x = np.pad(x, ((0, pad), (0, 0)))
        nm = np.pad(nm, (0, pad))

    owner = receivers // n_local
    # drop masked (padding) edges entirely; they are re-padded per shard
    keep = em > 0
    parts = []
    max_e = 0
    for p in range(n_parts):
        sel = keep & (owner == p)
        parts.append((senders[sel], receivers[sel] - p * n_local, y[sel]))
        max_e = max(max_e, int(sel.sum()))
    max_e = max(max_e, 1)
    if edge_capacity is not None:
        if edge_capacity < max_e:
            raise ValueError(
                f"edge_capacity={edge_capacity} < required shard edge "
                f"count {max_e}")
        max_e = int(edge_capacity)

    def pad_part(p, s, r, yy):
        e = len(s)
        pad = max_e - e
        return (
            # pad edges point at an OWNED row so they never create halo
            # demand; edge_mask == 0 zeroes their contributions.
            np.pad(s, (0, pad), constant_values=p * n_local),
            np.pad(r, (0, pad), constant_values=n_local - 1),
            np.pad(yy, (0, pad)),
            np.pad(np.ones(e, np.float32), (0, pad)),
        )

    padded = [pad_part(p, *part) for p, part in enumerate(parts)]

    # --- halo plan: need[p][q] = q-owned global rows p's edges reference
    need = [[np.zeros(0, np.int64)] * n_parts for _ in range(n_parts)]
    for p in range(n_parts):
        s = padded[p][0]
        s_owner = s // n_local
        for q in range(n_parts):
            if q == p:
                continue
            need[p][q] = np.unique(s[s_owner == q])
    s_pair = max(
        [len(need[p][q]) for p in range(n_parts) for q in range(n_parts)]
        + [1])
    s_pair = _round_up8(s_pair)
    if halo_capacity is not None:
        if halo_capacity < s_pair:
            raise ValueError(
                f"halo_capacity={halo_capacity} < required per-pair halo "
                f"size {s_pair}")
        s_pair = _round_up8(int(halo_capacity))

    senders_ext = []
    send_idx = []
    for p in range(n_parts):
        s = padded[p][0]
        s_owner = s // n_local
        ext = s - p * n_local  # local rows map directly
        for q in range(n_parts):
            if q == p:
                continue
            sel = s_owner == q
            # position of each remote sender within need[p][q]
            pos = np.searchsorted(need[p][q], s[sel])
            ext[sel] = n_local + q * s_pair + pos
        senders_ext.append(ext)
        # rows p sends: block q = what q needs FROM p (pad slots -> row 0;
        # their returning mo-partials are provably zero, see module doc)
        blocks = []
        for q in range(n_parts):
            rows = (need[q][p] - p * n_local) if q != p else np.zeros(0, np.int64)
            blocks.append(np.pad(rows, (0, s_pair - len(rows))))
        send_idx.append(np.concatenate(blocks))

    node_y = None
    if g.node_y is not None:
        node_y = np.asarray(g.node_y)
        if n_pad > n:
            node_y = np.pad(node_y, (0, n_pad - n))
        node_y = np.stack(np.split(node_y, n_parts)).astype(np.float32)

    return PartitionedGraph(
        x=np.stack(np.split(x, n_parts)).astype(np.float32),
        senders=np.stack([p[0] for p in padded]).astype(np.int32),
        receivers=np.stack([p[1] for p in padded]).astype(np.int32),
        y=np.stack([p[2] for p in padded]).astype(np.float32),
        edge_mask=np.stack([p[3] for p in padded]).astype(np.float32),
        node_mask=np.stack(np.split(nm, n_parts)).astype(np.float32),
        senders_ext=np.stack(senders_ext).astype(np.int32),
        send_idx=np.stack(send_idx).astype(np.int32),
        node_y=node_y,
    )


def _round_up8(x: int) -> int:
    return ((x + 7) // 8) * 8


# ---------------------------------------------------------------------------
# Sharded forward pass (inside shard_map over the 'graph' axis)
# ---------------------------------------------------------------------------

def _linear(p, x, mask=None):
    w = p["w"] if mask is None else p["w"] * mask
    return x @ w + p["b"]


def _global_receivers(shard: PartitionedGraph):
    """Local receiver ids -> global ids for this shard (uses axis index)."""
    p = jax.lax.axis_index(mesh_lib.GRAPH_AXIS)
    return shard.receivers + p * shard.x.shape[0]


def sharded_mpnn_logits(
    params,
    shard: PartitionedGraph,
    cfg,
    masks: Optional[dict] = None,
    exchange: str = "halo",
    head: str = "edge",
    unshared: bool = False,
):
    """MPNN forward over one shard, to run INSIDE shard_map with axis
    ``graph``.  ``shard`` holds this device's slice (no leading P axis).
    Returns this shard's edge logits [E_local] (``head="edge"``) or node
    logits [N_local] (``head="node"``, `MPNN_HitClassifier.ipynb:cell21`);
    ``unshared=True`` scans per-iteration weight stacks
    (`MPNN_Seg_Toy2D.ipynb:cell14`).  Honours ``cfg.compute_dtype``
    (bf16 mixed precision; logits return in f32).

    ``exchange="halo"`` (default): per iteration, pull only the boundary
    rows this shard's edges reference (one all_to_all over the
    precomputed ``send_idx`` plan), gather edges from the local+halo
    extended table, and push sender-side halo partials back to owners
    (reverse all_to_all + scatter-add).  Per-device node state is
    ``[N/P + P*S, D]``.  ``exchange="allgather"`` replicates the full
    activation matrix each iteration (round-1 behaviour; fallback for
    partitions with near-total halos).
    Semantics identical to `mpnn.segment_classifier_logits` (`model.py:140-156`).
    """
    act = cfg.activation
    masks_e = None if masks is None else masks.get("edge")
    masks_n = None if masks is None else masks.get("node")
    n_local = shard.x.shape[0]
    params, x_local = mpnn._cast_for_compute(
        params, shard.x, getattr(cfg, "compute_dtype", None))
    halo = exchange == "halo"

    h_local = act(_linear(params["input"], x_local))
    h_local = jnp.concatenate([h_local, x_local], axis=-1)

    if halo:
        senders = shard.senders_ext

        def exchange(h):
            """Pull this shard's halo rows (one all_to_all)."""
            send = jnp.take(h, shard.send_idx, axis=0)
            return jax.lax.all_to_all(send, mesh_lib.GRAPH_AXIS,
                                      split_axis=0, concat_axis=0,
                                      tiled=True)

        def extend(h):
            """Local table + pulled halo rows."""
            return jnp.concatenate([h, exchange(h)], axis=0)

        def reduce_ext(partials):
            """Return halo partials to their owners and add in."""
            local, ext = partials[:n_local], partials[n_local:]
            back = jax.lax.all_to_all(ext, mesh_lib.GRAPH_AXIS,
                                      split_axis=0, concat_axis=0,
                                      tiled=True)
            return local.at[shard.send_idx].add(back)

        n_ext = n_local + shard.send_idx.shape[0]
    else:
        senders = shard.senders

        def extend(h):
            return jax.lax.all_gather(h, mesh_lib.GRAPH_AXIS, axis=0,
                                      tiled=True)

        def reduce_ext(partials):
            return jax.lax.psum_scatter(partials, mesh_lib.GRAPH_AXIS,
                                        scatter_dimension=0, tiled=True)

        n_ext = n_local * jax.lax.axis_size(mesh_lib.GRAPH_AXIS)

    def recv_idx():
        if halo:
            return shard.receivers  # local ids index the extended table
        return _global_receivers(shard)

    em = shard.edge_mask.astype(x_local.dtype)[:, None]

    def edge_logits(edge_p, h_local, h_ext):
        """First edge-MLP layer split by endpoint (SURVEY §5: overlap the
        halo all_to_all with local work).  ``concat([bs, br]) @ W ==
        bs @ W[:D] + br @ W[D:]``, and in halo mode the receiver half
        gathers from ``h_local`` only — no data dependency on the
        exchange, so XLA's latency-hiding scheduler can run the E x D x H
        receiver matmul (and the gather feeding it) while the halo rows
        are in flight.  Only the sender half waits."""
        m1 = None if masks_e is None else masks_e["l1"]
        m2 = None if masks_e is None else masks_e["l2"]
        w1 = edge_p["l1"]["w"] if m1 is None else edge_p["l1"]["w"] * m1
        d = h_ext.shape[-1]
        bs = h_ext[senders] * em
        br = (h_local[shard.receivers] if halo else h_ext[recv_idx()]) * em
        z = act(bs @ w1[:d] + br @ w1[d:] + edge_p["l1"]["b"])
        return _linear(edge_p["l2"], z, m2)[..., 0]

    def body(h_local, per_iter):
        edge_p, node_p = per_iter
        h_ext = extend(h_local)
        e = jax.nn.sigmoid(edge_logits(edge_p, h_local, h_ext))
        # --- node network aggregation (`model.py:113-119`);
        # receiver gather stays on the local table (overlappable)
        bo = h_ext[senders] * em
        bi = (h_local[shard.receivers] if halo
              else h_ext[recv_idx()]) * em
        # mi: receiver-owned -> purely local
        mi = jax.ops.segment_sum(bo * e[:, None], shard.receivers,
                                 num_segments=n_local)
        # mo: partials over extended sender slots -> return to owners
        mo_partial = jax.ops.segment_sum(bi * e[:, None], senders,
                                         num_segments=n_ext)
        mo = reduce_ext(mo_partial)
        # --- node MLP (`model.py:94-98,120-125`) on local rows
        m = jnp.concatenate([mi, mo, h_local], axis=-1)
        mn1 = None if masks_n is None else masks_n["l1"]
        mn2 = None if masks_n is None else masks_n["l2"]
        hz = act(_linear(node_p["l1"], m, mn1))
        h_new = act(_linear(node_p["l2"], hz, mn2))
        h_local = jnp.concatenate([h_new, x_local], axis=-1)
        return h_local, None

    if unshared:
        h_local, _ = jax.lax.scan(
            body, h_local, (params["edge_stack"], params["node_stack"]),
            unroll=cfg.unroll)
    else:
        h_local, _ = jax.lax.scan(
            body, h_local,
            jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (cfg.n_iters,) + a.shape),
                (params["edge"], params["node"])),
            unroll=cfg.unroll)

    if head == "node":
        # per-node sigmoid head on owned rows (`MPNN_HitClassifier.ipynb`)
        return _linear(params["output"], h_local)[..., 0].astype(jnp.float32)
    out_p = params["output"] if unshared else params["edge"]
    return edge_logits(out_p, h_local, extend(h_local)).astype(jnp.float32)


def sharded_segment_classifier_logits(
    params,
    shard: PartitionedGraph,
    cfg: mpnn.SegmentClassifierConfig,
    masks: Optional[dict] = None,
    exchange: str = "halo",
):
    """Shared-weight SegmentClassifier over one shard (see
    :func:`sharded_mpnn_logits`)."""
    return sharded_mpnn_logits(params, shard, cfg, masks,
                               exchange=exchange, head="edge")


def make_sharded_forward(mesh: Mesh, cfg, masks=None,
                         exchange: str = "halo", head: str = "edge",
                         unshared: bool = False):
    """jittable ``(params, pg: PartitionedGraph[P-stacked]) -> logits [P, E]``
    running the sharded forward under shard_map on the ``graph`` axis."""
    def fwd(params, pg: PartitionedGraph):
        def inner(params, pg_shard):
            shard = jax.tree.map(lambda a: a[0], pg_shard)
            logits = sharded_mpnn_logits(
                params, shard, cfg, masks, exchange=exchange, head=head,
                unshared=unshared)
            return logits[None]

        return jax.shard_map(
            inner, mesh=mesh,
            in_specs=(P(), P(mesh_lib.GRAPH_AXIS)),
            out_specs=P(mesh_lib.GRAPH_AXIS),
        )(params, pg)

    return jax.jit(fwd)


def make_sharded_train_step(optimizer, mesh: Mesh, cfg,
                            l1: float = 0.0, masks=None,
                            exchange: str = "halo", target: str = "edge",
                            unshared: bool = False,
                            pos_weight: float = 1.0):
    """jitted data-parallel-free training step on ONE partitioned graph:
    masked BCE over all shards (psum), grads psum-ed by shard_map.
    ``target="node"`` trains the hit classifier on ``pg.node_y``."""
    import optax
    from gnn_fpga_jax.train.trainer import l1_penalty

    def loss_fn(params, pg: PartitionedGraph):
        def inner(params, pg_shard):
            shard = jax.tree.map(lambda a: a[0], pg_shard)
            logits = sharded_mpnn_logits(
                params, shard, cfg, masks, exchange=exchange,
                head=target, unshared=unshared)
            if target == "node":
                targets, mask = shard.node_y, shard.node_mask
            else:
                targets, mask = shard.y, shard.edge_mask
            per = optax.sigmoid_binary_cross_entropy(logits, targets)
            if pos_weight != 1.0:
                per = per * jnp.where(targets > 0.5, pos_weight, 1.0)
            local_sum = (per * mask).sum()
            local_cnt = mask.sum()
            total = jax.lax.psum(local_sum, mesh_lib.GRAPH_AXIS)
            cnt = jax.lax.psum(local_cnt, mesh_lib.GRAPH_AXIS)
            return (total / jnp.maximum(cnt, 1.0))[None]

        loss = jax.shard_map(
            inner, mesh=mesh,
            in_specs=(P(), P(mesh_lib.GRAPH_AXIS)),
            out_specs=P(mesh_lib.GRAPH_AXIS),
        )(params, pg)
        loss = loss.mean()  # identical on all shards
        if l1:
            loss = loss + l1 * l1_penalty(params, masks=masks)
        return loss

    def step(params, opt_state, pg):
        loss, grads = jax.value_and_grad(loss_fn)(params, pg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if masks is not None:
            from gnn_fpga_jax.compress.pruning import apply_masks_to_params
            params = apply_masks_to_params(params, masks)
        return params, opt_state, loss

    rep = NamedSharding(mesh, P())
    # prefix pytree: every PartitionedGraph leaf sharded on its P axis
    shard_sh = NamedSharding(mesh, P(mesh_lib.GRAPH_AXIS))
    return jax.jit(step, in_shardings=(rep, rep, shard_sh),
                   out_shardings=(rep, rep, rep))
