"""Dense-incidence (one-hot bmm) message-passing primitives.

The COO gather/scatter path (`ops/segment.py`) is the layout for
*large* graphs.  For the reference's graph sizes (O(100) nodes / O(1000)
edges per event, `MPNN_Seg_ACTS.ipynb`, `prepareGraphs.py`) this module
offers the *dense incidence-matrix bmm* instead — semantically the
reference's own ``bmm(Ri, ...)`` forms
(`/root/reference/gnn/model.py:69-81,113-125`) — which turns every
aggregation into a matmul:

    gather:  bo = Ro^T @ h          (one-hot [V,E]^T @ [V,F])
    scatter: mi = Ri @ (e * bo)     ([V,E] @ [E,F])

It executes ~V/2 matmul FLOPs per useful gather/scatter FLOP.  Incidence
matrices are built ONCE per batch (bf16, ~0.2MB/graph at mu10 scale) and
reused across message-passing iterations and fwd+bwd.  Which of the two
layouts is faster on the H100, and where, is not yet measured
(ROADMAP.md queue 1 item 3).

Use :func:`gnn_fpga_jax.models.mpnn.segment_classifier_logits` with
``cfg.aggregation="dense"`` (or the auto heuristic) to enable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def incidence(idx: jax.Array, n_node: int, edge_mask: jax.Array | None,
              dtype=jnp.bfloat16) -> jax.Array:
    """One-hot incidence matrix ``R[v, e] = 1 iff idx[e] == v`` — the
    reference's Ri/Ro (`graph.py:122-135`), masked columns zeroed.

    Shape ``[n_node, E]``.  ``dtype`` bf16 halves HBM traffic of the
    bmms; the matmuls accumulate in f32.
    """
    r = jax.nn.one_hot(idx, n_node, dtype=dtype, axis=-2)
    if edge_mask is not None:
        r = r * edge_mask.astype(dtype)[..., None, :]
    return r


def gather_bmm(r: jax.Array, h: jax.Array) -> jax.Array:
    """``bo[e] = h[idx[e]]`` as ``R^T @ h`` — edge-endpoint gather as a matmul.

    Equivalent to ``ops.segment.gather(h, idx) * edge_mask`` (masked rows
    are zero, matching dense zero-padding in the reference)."""
    return jnp.einsum("ve,vf->ef", r, h.astype(r.dtype))


def scatter_bmm(r: jax.Array, messages: jax.Array,
                weights: jax.Array | None = None) -> jax.Array:
    """``out[v] = sum_{e: idx[e]==v} weights[e] * messages[e]`` as
    ``R @ (weights * messages)`` — scatter-add as a matmul.

    The per-edge scaling is applied to the *messages* (E x F, cheap), not
    to the incidence matrix (V x E, would re-materialise it each call).
    Equivalent to ``ops.segment.weighted_segment_sum``."""
    m = messages.astype(r.dtype)
    if weights is not None:
        m = m * weights.astype(r.dtype)[..., None]
    return jnp.einsum("ve,ef->vf", r, m)
