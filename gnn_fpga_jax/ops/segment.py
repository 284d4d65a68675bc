"""Sparse message-passing primitives: gather / segment-sum on COO edges.

These are the COO replacements for the reference's dense
incidence-matrix ``bmm`` forms (`/root/reference/gnn/model.py:69-81,113-125`):

    bo = bmm(Ro^T, X)        ->  gather_senders(x, senders)
    bi = bmm(Ri^T, X)        ->  gather_receivers(x, receivers)
    mi = bmm(Ri * e, bo)     ->  segment_sum(e * bo, receivers, n_node)
    mo = bmm(Ro * e, bi)     ->  segment_sum(e * bi, senders, n_node)

All functions operate on a single graph; batch with ``jax.vmap``.  Padded
edges must be masked by the caller (multiply gathered features by
``edge_mask``) to reproduce the all-zero rows dense zero-padding yields.
XLA lowers these to native gather and scatter-add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather(x: jax.Array, idx: jax.Array) -> jax.Array:
    """``out[e] = x[idx[e]]`` — edge-endpoint feature gather.

    Equivalent to ``bmm(R^T, X)`` for an incidence matrix R with
    ``R[idx[e], e] = 1`` (`model.py:71-72`).
    """
    return jnp.take(x, idx, axis=0)


def segment_sum(messages: jax.Array, idx: jax.Array, n_node: int) -> jax.Array:
    """``out[n] = sum_{e: idx[e]==n} messages[e]`` — scatter-add aggregation.

    Equivalent to ``bmm(R, messages)`` (`model.py:114-119`).  ``idx`` values
    outside ``[0, n_node)`` are dropped (used for padding).
    """
    return jax.ops.segment_sum(messages, idx, num_segments=n_node)


def weighted_segment_sum(
    messages: jax.Array, weights: jax.Array, idx: jax.Array, n_node: int
) -> jax.Array:
    """``out[n] = sum_{e: idx[e]==n} weights[e] * messages[e]``.

    The edge-weighted aggregation ``bmm(R * e, messages)``
    (`model.py:115-119`)."""
    return segment_sum(messages * weights[:, None], idx, n_node)


def segment_mean(messages, idx, n_node, eps=1e-9):
    """Mean aggregation (used for row-normalised GCN adjacency)."""
    totals = segment_sum(messages, idx, n_node)
    counts = segment_sum(jnp.ones((messages.shape[0], 1), messages.dtype), idx, n_node)
    return totals / jnp.maximum(counts, eps)


def edge_concat(x: jax.Array, senders: jax.Array, receivers: jax.Array,
                edge_mask: jax.Array | None = None) -> jax.Array:
    """Per-edge concatenation ``[x[senders], x[receivers]]`` — the input of
    the reference EdgeNetwork (``B = cat([bo, bi])``, `model.py:69-73`).

    With ``edge_mask`` given, masked edges' rows are forced to zero, exactly
    matching the zero columns of zero-padded dense Ri/Ro.
    """
    b = jnp.concatenate([gather(x, senders), gather(x, receivers)], axis=-1)
    if edge_mask is not None:
        # cast avoids silent bf16->f32 promotion under mixed precision
        b = b * edge_mask.astype(b.dtype)[:, None]
    return b
