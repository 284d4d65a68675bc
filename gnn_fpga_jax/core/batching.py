"""Static-shape batching for variable-size graphs.

The reference pads each batch to its own max (`merge_graphs`,
`/root/reference/gnn/trainSegmentClassifier.py:66-95`) — fine for eager
PyTorch, poison for XLA (every new shape recompiles).  Here batches are
padded to *fixed bucket shapes* chosen once from the dataset, so the jitted
train step compiles exactly once per bucket.

``batch_generator`` reproduces the reference's infinite epoch generator
(`trainSegmentClassifier.py:97-111`) with static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from gnn_fpga_jax.core.graph import Graph, batch_graphs, pack_graphs, unbatch_graphs


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static (n_node, n_edge) pad targets for one size bucket."""
    n_node: int
    n_edge: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_bucket(graphs: Sequence[Graph], node_multiple: int = 8,
                  edge_multiple: int = 128) -> BucketSpec:
    """One bucket covering every graph, rounded up to fixed multiples
    (lanes=128 on the edge axis, sublanes=8 on the node axis); +1 node slot
    is reserved as the zero-feature pad node."""
    max_n = max(int(np.asarray(g.x).shape[0]) for g in graphs) + 1
    max_e = max(int(np.asarray(g.senders).shape[0]) for g in graphs)
    return BucketSpec(_round_up(max_n, node_multiple),
                      max(_round_up(max_e, edge_multiple), edge_multiple))


def choose_buckets(graphs: Sequence[Graph], n_buckets: int,
                   node_multiple: int = 8, edge_multiple: int = 128) -> List[BucketSpec]:
    """Quantile-based size buckets over edge count; each bucket's spec covers
    its members.  Cuts padding waste on heavy-tailed size distributions
    (mu200 full events) at the cost of one compile per bucket."""
    sizes = np.array([int(np.asarray(g.senders).shape[0]) for g in graphs])
    qs = np.quantile(sizes, np.linspace(0, 1, n_buckets + 1)[1:])
    specs = []
    for i, hi in enumerate(qs):
        lo = 0 if i == 0 else qs[i - 1]
        members = [g for g, s in zip(graphs, sizes) if (s <= hi and (i == 0 or s > lo))]
        if members:
            specs.append(choose_bucket(members, node_multiple, edge_multiple))
    return specs


def assign_bucket(g: Graph, specs: Sequence[BucketSpec]) -> BucketSpec:
    n = int(np.asarray(g.x).shape[0]) + 1
    e = int(np.asarray(g.senders).shape[0])
    for spec in sorted(specs, key=lambda s: s.n_edge):
        if n <= spec.n_node and e <= spec.n_edge:
            return spec
    raise ValueError(f"no bucket fits graph with {n - 1} nodes / {e} edges")


def _bucket_pools(graphs: Sequence[Graph], specs: Sequence[BucketSpec],
                  batch_size: int) -> List[tuple]:
    """Assign graphs to the smallest fitting bucket; pools too small to
    form one batch are merged upward into the next larger bucket.

    Buckets are ordered by edge count, so the destination of a merge may
    have a *smaller* node target than the merged graphs (bimodal data:
    many-node/few-edge vs few-node/many-edge); the destination spec is
    expanded to dominate on both dims so padding never fails mid-epoch.
    A trailing undersized pool has no larger bucket to merge into — it is
    dropped with a warning (those graphs would otherwise silently never
    train).
    """
    ordered = sorted(specs, key=lambda s: (s.n_edge, s.n_node))
    pools: List[List[int]] = [[] for _ in ordered]
    for gi, g in enumerate(graphs):
        spec = assign_bucket(g, ordered)
        pools[ordered.index(spec)].append(gi)
    for i in range(len(ordered) - 1):
        if 0 < len(pools[i]) < batch_size:
            pools[i + 1] = pools[i] + pools[i + 1]
            pools[i] = []
            ordered[i + 1] = BucketSpec(
                n_node=max(ordered[i].n_node, ordered[i + 1].n_node),
                n_edge=max(ordered[i].n_edge, ordered[i + 1].n_edge))
    if 0 < len(pools[-1]) < batch_size:
        import warnings
        warnings.warn(
            f"bucket {ordered[-1]} holds {len(pools[-1])} graphs < "
            f"batch_size={batch_size}; they are excluded from every epoch "
            f"(use fewer buckets or a smaller batch size)",
            stacklevel=3)
    return [(spec, np.array(pool))
            for spec, pool in zip(ordered, pools) if len(pool) >= batch_size]


def batch_generator(
    graphs: Sequence[Graph],
    batch_size: int,
    bucket=None,
    shuffle: bool = True,
    seed: int = 0,
    packed: bool = False,
    transform=None,
) -> Iterator[Graph]:
    """Infinite generator of static-shape batches.

    ``packed=False`` yields a batched Graph ``[B, ...]`` (vmapped models);
    ``packed=True`` yields one flat packed graph of ``B`` events (single
    segment-sum).

    ``bucket`` may be a single :class:`BucketSpec` (or None: one bucket
    covering everything) or a *sequence* of specs (from
    :func:`choose_buckets`): graphs are then grouped into their smallest
    fitting bucket and each bucket yields its own static shape — one XLA
    compile per bucket, far less padding on heavy-tailed size
    distributions (SURVEY.md §5; the mu200 full-event case).

    ``graphs`` may be a list of single graphs or one already-batched Graph
    (as the toy generators return) — the latter is split first.

    ``transform``: optional ``transform(batch, indices) -> batch`` applied
    to every emitted batch, with the source indices of the selected graphs
    (into ``graphs``, in pack/stack order) — the hook for attaching
    per-batch aggregation plans (blocked layer plans from per-graph layer
    offsets) or partitioning the batch across a mesh.  The transform must return static shapes per bucket or
    every emission recompiles the train step.
    """
    if isinstance(graphs, Graph):
        graphs = unbatch_graphs(graphs)
    if bucket is None:
        bucket = choose_bucket(graphs)
    specs = list(bucket) if isinstance(bucket, (list, tuple)) else [bucket]
    pools = _bucket_pools(graphs, specs, batch_size)
    if not pools:
        raise ValueError("fewer graphs than batch_size")
    rng = np.random.default_rng(seed)

    def emit(spec: BucketSpec, sel) -> Graph:
        chunk = [graphs[i] for i in sel]
        if packed:
            batch = pack_graphs(chunk, n_node=spec.n_node * batch_size,
                                n_edge=spec.n_edge * batch_size)
        else:
            batch = batch_graphs(chunk, spec.n_node, spec.n_edge)
        if transform is not None:
            batch = transform(batch, list(sel))
        return batch

    while True:
        plan = []
        for spec, pool in pools:
            order = rng.permutation(pool) if shuffle else pool
            for b in range(len(pool) // batch_size):
                plan.append((spec, order[b * batch_size:(b + 1) * batch_size]))
        if shuffle:
            rng.shuffle(plan)
        for spec, sel in plan:
            yield emit(spec, sel)


def padding_efficiency(graphs: Sequence[Graph], bucket,
                       batch_size: int) -> float:
    """Fraction of padded edge slots holding real edges under the given
    bucket(s) — the metric multi-bucket batching improves."""
    if isinstance(graphs, Graph):
        graphs = unbatch_graphs(graphs)
    specs = list(bucket) if isinstance(bucket, (list, tuple)) else [bucket]
    pools = _bucket_pools(graphs, specs, batch_size)
    real = padded = 0
    for spec, pool in pools:
        n_full = len(pool) // batch_size
        used = pool[: n_full * batch_size]
        real += sum(int(np.asarray(graphs[i].edge_mask).sum()) for i in used)
        padded += n_full * batch_size * spec.n_edge
    return real / max(padded, 1)


def n_batches_per_epoch(n_graphs: int, batch_size: int) -> int:
    return n_graphs // batch_size
