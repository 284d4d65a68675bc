"""Message-passing GNN models (interaction-network family).

Re-designs the reference models (`/root/reference/gnn/model.py`,
`MPNN_Seg_Toy2D.ipynb:cell14`, `MPNN_HitClassifier.ipynb:cell21`) as pure
functions over parameter pytrees operating on COO :class:`~gnn_fpga_jax.core.graph.Graph`s:

- ``SegmentClassifier``  — edge (track-segment) classifier with weights
  *shared* across message-passing iterations (`model.py:127-156`); the
  recurrence is a ``lax.scan`` so XLA compiles one iteration body.
- ``SegmentClassifierUnshared`` — per-iteration weights + separate output
  edge network (`MPNN_Seg_Toy2D.ipynb:cell14`); scan over stacked params.
- ``NodeClassifier``     — node (hit) classifier with a per-node sigmoid
  output head (`MPNN_HitClassifier.ipynb:cell21`).

Weight masking for iterative magnitude pruning (the reference's
``MaskedLinear``, `model.py:14-33` / `model_maskedlinear.py:16-44`) is a
*mask pytree* of the same structure as the params, applied as ``w * mask``
inside each matmul — no special layer class needed.

All dense compute runs through plain matmuls so XLA can fuse the tanh /
sigmoid epilogues.  Batching = ``jax.vmap`` over a leading axis, or pass
one packed graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from gnn_fpga_jax.core.graph import Graph
from gnn_fpga_jax.ops import segment as ops
from gnn_fpga_jax.ops import dense_incidence as dinc

Params = Any  # nested dict pytree of jnp arrays
Masks = Any   # same structure as Params['...']['w'] leaves, or None


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

def _init_linear(key, in_dim: int, out_dim: int, dtype=jnp.float32):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias — the PyTorch
    0.4 ``nn.Linear`` default, kept for training-dynamics parity with the
    reference."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(jnp.asarray(in_dim, dtype=jnp.float32))
    return {
        "w": jax.random.uniform(kw, (in_dim, out_dim), dtype, -bound, bound),
        "b": jax.random.uniform(kb, (out_dim,), dtype, -bound, bound),
    }


def _linear(p, x, mask=None):
    w = p["w"] if mask is None else p["w"] * mask
    return x @ w + p["b"]


def init_edge_network(key, input_dim: int, hidden_dim: int, dtype=jnp.float32):
    """Two-layer edge MLP: (2*input_dim -> hidden -> 1)  (`model.py:41-49`)."""
    k1, k2 = jax.random.split(key)
    return {
        "l1": _init_linear(k1, 2 * input_dim, hidden_dim, dtype),
        "l2": _init_linear(k2, hidden_dim, 1, dtype),
    }


def init_node_network(key, input_dim: int, output_dim: int, dtype=jnp.float32):
    """Two-layer node MLP: (3*input_dim -> out -> out)  (`model.py:94-98`)."""
    k1, k2 = jax.random.split(key)
    return {
        "l1": _init_linear(k1, 3 * input_dim, output_dim, dtype),
        "l2": _init_linear(k2, output_dim, output_dim, dtype),
    }


# ---------------------------------------------------------------------------
# Edge / node network application
# ---------------------------------------------------------------------------

def edge_network_logits(
    params, h, graph: Graph, masks: Masks = None, activation=jnp.tanh
):
    """Edge-score *logits* (pre-sigmoid) for every edge.

    Reference: EdgeNetwork.forward (`model.py:69-81`) —
    ``B = [h[senders], h[receivers]]`` -> Linear -> tanh -> Linear.
    Returning logits lets the trainer use the numerically stable
    sigmoid-BCE; apply ``jax.nn.sigmoid`` for the reference's probability
    output.
    """
    b = ops.edge_concat(h, graph.senders, graph.receivers, graph.edge_mask)
    m1 = None if masks is None else masks["l1"]
    m2 = None if masks is None else masks["l2"]
    z = activation(_linear(params["l1"], b, m1))
    return _linear(params["l2"], z, m2)[..., 0]


def edge_network(params, h, graph, masks=None, activation=jnp.tanh):
    """Edge scores in (0,1) — sigmoid of :func:`edge_network_logits`."""
    return jax.nn.sigmoid(edge_network_logits(params, h, graph, masks, activation))


def node_mlp(params, mi, mo, h, masks: Masks = None, activation=jnp.tanh):
    """The node MLP half of :func:`node_network` on precomputed
    aggregations (`model.py:94-98,120-125`)."""
    m = jnp.concatenate([mi, mo, h], axis=-1)
    m1 = None if masks is None else masks["l1"]
    m2 = None if masks is None else masks["l2"]
    z = activation(_linear(params["l1"], m, m1))
    return activation(_linear(params["l2"], z, m2))


def node_network(
    params, h, e, graph: Graph, masks: Masks = None, activation=jnp.tanh,
):
    """New node features from edge-weighted neighbour aggregation.

    Reference: NodeNetwork.forward (`model.py:113-125`) —
    ``mi[n] = sum_{e: recv==n} e * h[send]``,
    ``mo[n] = sum_{e: send==n} e * h[recv]``,
    ``M = [mi, mo, h]`` -> Linear -> tanh -> Linear -> tanh.
    """
    n = h.shape[0]
    em = graph.edge_mask.astype(h.dtype)
    bo = ops.gather(h, graph.senders) * em[:, None]
    bi = ops.gather(h, graph.receivers) * em[:, None]
    mi = ops.weighted_segment_sum(bo, e, graph.receivers, n)
    mo = ops.weighted_segment_sum(bi, e, graph.senders, n)
    return node_mlp(params, mi, mo, h, masks, activation)


# ---------------------------------------------------------------------------
# SegmentClassifier (shared weights across iterations)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentClassifierConfig:
    input_dim: int = 3
    hidden_dim: int = 8
    n_iters: int = 3
    # activation applied in all hidden layers (reference default nn.Tanh)
    activation: Callable = jnp.tanh
    dtype: Any = jnp.float32
    # Mixed precision: params stay in `dtype` (f32 master weights); the
    # forward pass runs in `compute_dtype` when set (bf16 halves HBM
    # traffic). Logits return in f32.
    compute_dtype: Any = None
    # Unroll factor for the message-passing recurrence scan.  True (full
    # unroll) keeps a nested scan out of Trainer.run_steps' outer scan.
    # Chosen on earlier hardware; not yet measured on the H100
    # (ROADMAP.md queue 1 item 3).
    unroll: Any = True
    # Aggregation layout: "sparse" = COO gather/segment-sum, "dense" =
    # one-hot incidence bmm (see ops/dense_incidence.py), "blocked" =
    # per-layer-pair block-diagonal incidence bmms (~n_layers x fewer
    # FLOPs than dense on layered graphs; requires graph.blocks, see
    # ops/blocked.py), "auto" = blocked if blocks attached, else dense
    # iff n_node * n_edge fits a small one-hot, else sparse.
    aggregation: str = "auto"
    # Rematerialise the message-passing iteration in the backward pass
    # (jax.checkpoint on the scan body): trades the stores/loads of the
    # per-iteration [E, H] residuals for recompute.
    remat: bool = False


def _cast_for_compute(params, x, compute_dtype):
    if compute_dtype is None:
        return params, x
    cast = lambda a: (a.astype(compute_dtype)
                      if jnp.issubdtype(a.dtype, jnp.floating) else a)
    return jax.tree.map(cast, params), cast(x)


def init_segment_classifier(key, cfg: SegmentClassifierConfig) -> Params:
    """Params for the shared-weight SegmentClassifier (`model.py:128-138`)."""
    k_in, k_e, k_n = jax.random.split(key, 3)
    d = cfg.input_dim + cfg.hidden_dim
    return {
        "input": _init_linear(k_in, cfg.input_dim, cfg.hidden_dim, cfg.dtype),
        "edge": init_edge_network(k_e, d, cfg.hidden_dim, cfg.dtype),
        "node": init_node_network(k_n, d, cfg.hidden_dim, cfg.dtype),
    }


# auto routes dense below this n_node*n_edge product (the one-hot is
# V*E*2B in bf16: 8M ~ 16MB/graph/direction).  Chosen on earlier
# hardware; not yet measured on the H100 (ROADMAP.md queue 1 item 3).
_DENSE_AUTO_LIMIT = 8_000_000


def _use_dense(cfg, graph: Graph) -> bool:
    if cfg.aggregation == "dense":
        return True
    if cfg.aggregation == "sparse":
        return False
    if graph.x.shape[-2] * graph.senders.shape[-1] <= _DENSE_AUTO_LIMIT:
        return True
    # Above the one-hot limit with no blocks attached auto lands on the
    # XLA gather/segment-sum path; say so once per call site, since a
    # layered graph could have taken the blocked route instead.
    import warnings
    warnings.warn(
        f"aggregation='auto' on a graph with n_node*n_edge = "
        f"{graph.x.shape[-2] * graph.senders.shape[-1]:,} > "
        f"{_DENSE_AUTO_LIMIT:,} and no blocks attached: falling back to "
        "the XLA segment-sum path.  Attach a layered block plan "
        "(ops.blocked.attach_blocks_layered) to route blocked.",
        stacklevel=3)
    return False


def _use_blocked(cfg, graph: Graph) -> bool:
    """Blocked (layered) incidence path: requested explicitly, or
    auto-selected when the graph carries a BlockedPlan
    (ops/blocked.attach_blocks_layered)."""
    if cfg.aggregation == "blocked":
        if graph.blocks is None:
            raise ValueError(
                "aggregation='blocked' needs graph.blocks — attach with "
                "gnn_fpga_jax.ops.blocked.attach_blocks_layered(graph, "
                "layer_offsets)")
        return True
    return cfg.aggregation == "auto" and graph.blocks is not None


def _dense_edge_logits(params, bo, bi, masks_e, act):
    """Edge MLP on precomputed endpoint features (`model.py:69-81`)."""
    b = jnp.concatenate([bo, bi], axis=-1)
    m1 = None if masks_e is None else masks_e["l1"]
    m2 = None if masks_e is None else masks_e["l2"]
    z = act(_linear(params["l1"], b, m1))
    return _linear(params["l2"], z, m2)[..., 0]


def _dense_mp_body(ri, ro, x, masks_e, masks_n, act):
    """One message-passing iteration with one-hot incidence bmms.

    Returns ``body(h, (edge_params, node_params)) -> (h', None)`` for use
    under ``lax.scan`` — shared weights pass a constant params pair,
    unshared weights scan over stacked per-iteration params.  bo/bi are
    shared between the edge scorer and the aggregation, as in the
    reference (the same `bmm(Ro^T,X)`/`bmm(Ri^T,X)` feed both,
    `model.py:69-81,113-119`)."""

    def body(h, per_iter):
        edge_p, node_p = per_iter
        bo = dinc.gather_bmm(ro, h)
        bi = dinc.gather_bmm(ri, h)
        e = jax.nn.sigmoid(_dense_edge_logits(edge_p, bo, bi, masks_e, act))
        mi = dinc.scatter_bmm(ri, bo, e)
        mo = dinc.scatter_bmm(ro, bi, e)
        m = jnp.concatenate([mi, mo, h], axis=-1)
        m1 = None if masks_n is None else masks_n["l1"]
        m2 = None if masks_n is None else masks_n["l2"]
        z = act(_linear(node_p["l1"], m, m1))
        hn = act(_linear(node_p["l2"], z, m2))
        return jnp.concatenate([hn, x], axis=-1), None

    return body


def _blocked_prelude(params, graph: Graph, cfg, act):
    """Cast params/features, build the block broadcast matrix + local
    incidence one-hots (see ops/blocked.py), run the input MLP."""
    from gnn_fpga_jax.ops import blocked as blk
    plan = graph.blocks
    params, x = _cast_for_compute(params, graph.x, cfg.compute_dtype)
    g = blk.broadcast_matrix(plan, graph.x.shape[-2], x.dtype)
    ri, ro = blk.local_incidence(plan, graph.edge_mask, x.dtype)
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)
    return params, x, g, ri, ro, plan.n_blocks, h


def _blocked_mp_body(g, ri, ro, x, masks_e, masks_n, act, n_blocks):
    """One message-passing iteration in blocked (layered) layout — the
    same contraction as `_dense_mp_body` restricted to the non-zero
    blocks of the incidence (~n_layers x fewer FLOPs and HBM reads on
    layered graphs; see ops/blocked.py).  Edge logits come out in
    blocked order, which IS the graph's edge order after
    `attach_blocks_layered`."""
    from gnn_fpga_jax.ops import blocked as blk

    def body(h, per_iter):
        edge_p, node_p = per_iter
        hb = blk.gather_blocks(g, h, n_blocks)
        bo = blk.gather_bmm(ro, hb)
        bi = blk.gather_bmm(ri, hb)
        e = jax.nn.sigmoid(_dense_edge_logits(edge_p, bo, bi, masks_e, act))
        mi = blk.reduce_blocks(g, blk.scatter_bmm(ri, bo, e))
        mo = blk.reduce_blocks(g, blk.scatter_bmm(ro, bi, e))
        m = jnp.concatenate([mi, mo, h], axis=-1)
        m1 = None if masks_n is None else masks_n["l1"]
        m2 = None if masks_n is None else masks_n["l2"]
        z = act(_linear(node_p["l1"], m, m1))
        hn = act(_linear(node_p["l2"], z, m2))
        return jnp.concatenate([hn, x], axis=-1), None

    return body


def _blocked_mp_logits(params, graph: Graph, cfg, masks_e, masks_n, act):
    """SegmentClassifier forward on the blocked path."""
    from gnn_fpga_jax.ops import blocked as blk
    params, x, g, ri, ro, nb, h = _blocked_prelude(params, graph, cfg, act)
    body = _blocked_mp_body(g, ri, ro, x, masks_e, masks_n, act, nb)
    h, _ = jax.lax.scan(lambda h, _: body(h, (params["edge"], params["node"])),
                        h, None, length=cfg.n_iters, unroll=cfg.unroll)
    hb = blk.gather_blocks(g, h, nb)
    bo = blk.gather_bmm(ro, hb)
    bi = blk.gather_bmm(ri, hb)
    logits = _dense_edge_logits(params["edge"], bo, bi, masks_e, act)
    return logits.reshape(-1).astype(jnp.float32)


def _dense_prelude(params, graph: Graph, cfg, act):
    """Cast params/features, build incidence matrices, run the input MLP."""
    n_node = graph.x.shape[-2]
    params, x = _cast_for_compute(params, graph.x, cfg.compute_dtype)
    ri = dinc.incidence(graph.receivers, n_node, graph.edge_mask, x.dtype)
    ro = dinc.incidence(graph.senders, n_node, graph.edge_mask, x.dtype)
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)
    return params, x, ri, ro, h


def _dense_mp_logits(params, graph: Graph, cfg, masks_e, masks_n, act):
    """SegmentClassifier forward on the dense one-hot path (see
    ops/dense_incidence.py).

    Semantically identical to the sparse forward; the incidence matrices
    are the reference's Ri/Ro (`model.py:113-119`) built once per call in
    the compute dtype and reused across iterations and fwd/bwd."""
    params, x, ri, ro, h = _dense_prelude(params, graph, cfg, act)
    body = _dense_mp_body(ri, ro, x, masks_e, masks_n, act)
    h, _ = jax.lax.scan(lambda h, _: body(h, (params["edge"], params["node"])),
                        h, None, length=cfg.n_iters, unroll=cfg.unroll)
    bo = dinc.gather_bmm(ro, h)
    bi = dinc.gather_bmm(ri, h)
    logits = _dense_edge_logits(params["edge"], bo, bi, masks_e, act)
    return logits.astype(jnp.float32)


def segment_classifier_logits(
    params: Params,
    graph: Graph,
    cfg: SegmentClassifierConfig,
    masks: Optional[dict] = None,
) -> jax.Array:
    """Forward pass returning final edge logits.

    Reference: SegmentClassifier.forward (`model.py:140-156`):
    input MLP -> shortcut concat [H, X] -> n_iters x (edge net -> node net ->
    shortcut concat) -> final edge net.  Weight sharing across iterations
    becomes a ``lax.scan`` with a static body.  Aggregation layout per
    ``cfg.aggregation`` (dense incidence bmm for small graphs, blocked
    for layered graphs with blocks attached, COO gather/segment-sum
    otherwise).
    """
    act = cfg.activation
    masks_e = None if masks is None else masks.get("edge")
    masks_n = None if masks is None else masks.get("node")
    if _use_blocked(cfg, graph):
        return _blocked_mp_logits(params, graph, cfg, masks_e, masks_n, act)
    if _use_dense(cfg, graph):
        return _dense_mp_logits(params, graph, cfg, masks_e, masks_n, act)
    params, x = _cast_for_compute(params, graph.x, cfg.compute_dtype)
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)

    def body(h, _):
        e = jax.nn.sigmoid(
            edge_network_logits(params["edge"], h, graph, masks_e, act))
        h = node_network(params["node"], h, e, graph, masks_n, act)
        h = jnp.concatenate([h, x], axis=-1)
        return h, None

    if cfg.remat:
        body = jax.checkpoint(body)
    h, _ = jax.lax.scan(body, h, None, length=cfg.n_iters, unroll=cfg.unroll)
    logits = edge_network_logits(params["edge"], h, graph, masks_e, act)
    return logits.astype(jnp.float32)


def segment_classifier(params, graph, cfg, masks=None):
    """Edge probabilities, matching the reference model's sigmoid output."""
    return jax.nn.sigmoid(segment_classifier_logits(params, graph, cfg, masks))


def segment_classifier_intermediates(params, graph, cfg, masks=None):
    """Forward pass that also returns per-iteration (e, H) activations, for
    the activation-parity gate and for the iteration-evolution plots
    (`MPNN_Seg_ACTS.ipynb:cell39-46` ``graph_iter``)."""
    act = cfg.activation
    x = graph.x
    masks_e = None if masks is None else masks.get("edge")
    masks_n = None if masks is None else masks.get("node")
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)
    es, hs = [], [h]
    for _ in range(cfg.n_iters):
        e = edge_network(params["edge"], h, graph, masks_e, act)
        h = node_network(params["node"], h, e, graph, masks_n, act)
        h = jnp.concatenate([h, x], axis=-1)
        es.append(e)
        hs.append(h)
    logits = edge_network_logits(params["edge"], h, graph, masks_e, act)
    return jax.nn.sigmoid(logits), es, hs


# ---------------------------------------------------------------------------
# SegmentClassifierUnshared (per-iteration weights, Toy2D notebook variant)
# ---------------------------------------------------------------------------

def init_segment_classifier_unshared(key, cfg: SegmentClassifierConfig) -> Params:
    """Per-iteration edge/node nets + separate output edge net
    (`MPNN_Seg_Toy2D.ipynb:cell14` SegmentClassifier with ModuleLists).

    The per-iteration params are *stacked* along a leading axis so the
    forward pass can ``lax.scan`` over them.
    """
    k_in, k_out, *ks = jax.random.split(key, 2 + 2 * cfg.n_iters)
    d = cfg.input_dim + cfg.hidden_dim
    edge_ps = [init_edge_network(ks[2 * i], d, cfg.hidden_dim, cfg.dtype)
               for i in range(cfg.n_iters)]
    node_ps = [init_node_network(ks[2 * i + 1], d, cfg.hidden_dim, cfg.dtype)
               for i in range(cfg.n_iters)]
    stack = lambda ps: jax.tree.map(lambda *a: jnp.stack(a), *ps)
    return {
        "input": _init_linear(k_in, cfg.input_dim, cfg.hidden_dim, cfg.dtype),
        "edge_stack": stack(edge_ps),
        "node_stack": stack(node_ps),
        "output": init_edge_network(k_out, d, cfg.hidden_dim, cfg.dtype),
    }


def segment_classifier_unshared_logits(params, graph, cfg, masks=None):
    act = cfg.activation
    if _use_blocked(cfg, graph):
        from gnn_fpga_jax.ops import blocked as blk
        params, x, g, ri, ro, nb, h = _blocked_prelude(params, graph, cfg, act)
        body = _blocked_mp_body(g, ri, ro, x, None, None, act, nb)
        h, _ = jax.lax.scan(body, h,
                            (params["edge_stack"], params["node_stack"]),
                            unroll=cfg.unroll)
        hb = blk.gather_blocks(g, h, nb)
        bo = blk.gather_bmm(ro, hb)
        bi = blk.gather_bmm(ri, hb)
        logits = _dense_edge_logits(params["output"], bo, bi, None, act)
        return logits.reshape(-1).astype(jnp.float32)
    if _use_dense(cfg, graph):
        params, x, ri, ro, h = _dense_prelude(params, graph, cfg, act)
        body = _dense_mp_body(ri, ro, x, None, None, act)
        h, _ = jax.lax.scan(body, h,
                            (params["edge_stack"], params["node_stack"]),
                            unroll=cfg.unroll)
        bo = dinc.gather_bmm(ro, h)
        bi = dinc.gather_bmm(ri, h)
        logits = _dense_edge_logits(params["output"], bo, bi, None, act)
        return logits.astype(jnp.float32)
    params, x = _cast_for_compute(params, graph.x, cfg.compute_dtype)
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)

    def body(h, per_iter):
        ep, np_ = per_iter
        e = jax.nn.sigmoid(edge_network_logits(ep, h, graph, None, act))
        h = node_network(np_, h, e, graph, None, act)
        h = jnp.concatenate([h, x], axis=-1)
        return h, None

    h, _ = jax.lax.scan(body, h, (params["edge_stack"], params["node_stack"]),
                        unroll=cfg.unroll)
    logits = edge_network_logits(params["output"], h, graph, None, act)
    return logits.astype(jnp.float32)


def segment_classifier_unshared(params, graph, cfg, masks=None):
    return jax.nn.sigmoid(segment_classifier_unshared_logits(params, graph, cfg, masks))


# ---------------------------------------------------------------------------
# NodeClassifier (hit classifier)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeClassifierConfig:
    input_dim: int = 4
    hidden_dim: int = 8
    n_iters: int = 1
    activation: Callable = jnp.tanh
    dtype: Any = jnp.float32
    # see SegmentClassifierConfig.unroll
    unroll: Any = True
    # see SegmentClassifierConfig.aggregation
    aggregation: str = "auto"
    compute_dtype: Any = None
    # see SegmentClassifierConfig.remat
    remat: bool = False


def init_node_classifier(key, cfg: NodeClassifierConfig) -> Params:
    """Shared-weight MPNN + per-node sigmoid head
    (`MPNN_HitClassifier.ipynb:cell21`)."""
    k_in, k_e, k_n, k_o = jax.random.split(key, 4)
    d = cfg.input_dim + cfg.hidden_dim
    return {
        "input": _init_linear(k_in, cfg.input_dim, cfg.hidden_dim, cfg.dtype),
        "edge": init_edge_network(k_e, d, cfg.hidden_dim, cfg.dtype),
        "node": init_node_network(k_n, d, cfg.hidden_dim, cfg.dtype),
        "output": _init_linear(k_o, d, 1, cfg.dtype),
    }


def node_classifier_logits(params, graph, cfg: NodeClassifierConfig, masks=None):
    act = cfg.activation
    masks_e = None if masks is None else masks.get("edge")
    masks_n = None if masks is None else masks.get("node")
    if _use_blocked(cfg, graph):
        # blocked (layered) incidence path — the candidate graphs of the
        # hit-classifier workload (`MPNN_HitClassifier.ipynb:cell12-15`)
        # are layered too; the node head reads the global node table,
        # which the blocked body maintains unchanged.
        params, x, g, ri, ro, nb, h = _blocked_prelude(params, graph, cfg, act)
        body = _blocked_mp_body(g, ri, ro, x, masks_e, masks_n, act, nb)
        h, _ = jax.lax.scan(
            lambda h, _: body(h, (params["edge"], params["node"])),
            h, None, length=cfg.n_iters, unroll=cfg.unroll)
        return _linear(params["output"], h)[..., 0].astype(jnp.float32)
    if _use_dense(cfg, graph):
        params, x, ri, ro, h = _dense_prelude(params, graph, cfg, act)
        body = _dense_mp_body(ri, ro, x, masks_e, masks_n, act)
        h, _ = jax.lax.scan(
            lambda h, _: body(h, (params["edge"], params["node"])),
            h, None, length=cfg.n_iters, unroll=cfg.unroll)
        return _linear(params["output"], h)[..., 0].astype(jnp.float32)
    params, x = _cast_for_compute(params, graph.x, cfg.compute_dtype)
    h = act(_linear(params["input"], x))
    h = jnp.concatenate([h, x], axis=-1)

    def body(h, _):
        e = jax.nn.sigmoid(
            edge_network_logits(params["edge"], h, graph, masks_e, act))
        h = node_network(params["node"], h, e, graph, masks_n, act)
        h = jnp.concatenate([h, x], axis=-1)
        return h, None

    if cfg.remat:
        body = jax.checkpoint(body)
    h, _ = jax.lax.scan(body, h, None, length=cfg.n_iters, unroll=cfg.unroll)
    return _linear(params["output"], h)[..., 0].astype(jnp.float32)


def node_classifier(params, graph, cfg, masks=None):
    return jax.nn.sigmoid(node_classifier_logits(params, graph, cfg, masks))


def count_params(params) -> int:
    """Total parameter count (reference logs this at `estimator.py:43-44`)."""
    return sum(int(p.size) for p in jax.tree.leaves(params))
