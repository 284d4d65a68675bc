"""Data-parallel training over a device mesh (pjit / GSPMD).

The replacement for the data parallelism the reference lacks
entirely (SURVEY.md §2.3: single process, `batch_size` loop only): the batch
axis of a batched :class:`~gnn_fpga_jax.core.graph.Graph` is sharded across
the mesh ``data`` axis, parameters and optimiser state are replicated, and
XLA inserts the gradient all-reduce automatically because the loss
averages over the (sharded) batch.

No collective is written by hand — the GSPMD partitioner derives the psum
from the sharding annotations, which is the idiomatic JAX scaling recipe.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnn_fpga_jax.core.graph import Graph
from gnn_fpga_jax.parallel import mesh as mesh_lib
from gnn_fpga_jax.train.trainer import TrainConfig, l1_penalty, masked_bce_with_logits


def make_dp_loss_fn(logits_fn: Callable, cfg: TrainConfig, masks=None):
    """Masked mean BCE over a batched graph (leading batch axis)."""

    def loss_fn(params, graph: Graph):
        logits = jax.vmap(lambda g: logits_fn(params, g, masks))(graph)
        if cfg.target == "edge":
            targets, mask = graph.y, graph.edge_mask
        else:
            targets, mask = graph.node_y, graph.node_mask
        loss = masked_bce_with_logits(
            logits, targets, mask if cfg.loss_masking else None,
            cfg.pos_weight)
        if cfg.l1:
            loss = loss + cfg.l1 * l1_penalty(params, masks=masks)
        return loss

    return loss_fn


def make_dp_train_step(
    logits_fn: Callable,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    cfg: TrainConfig = TrainConfig(),
    masks=None,
    donate: bool = True,
    has_node_y: bool = False,
):
    """jitted ``(params, opt_state, graph) -> (params, opt_state, loss)``
    with batch sharded over the mesh ``data`` axis and replicated params.

    ``has_node_y`` must match whether the batched Graph carries node labels
    (pytree structures must agree for in_shardings).
    """
    loss_fn = make_dp_loss_fn(logits_fn, cfg, masks)
    rep = NamedSharding(mesh, P())
    bsh = NamedSharding(mesh, P(mesh_lib.DATA_AXIS))

    def step(params, opt_state, graph):
        loss, grads = jax.value_and_grad(loss_fn)(params, graph)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if masks is not None:
            from gnn_fpga_jax.compress.pruning import apply_masks_to_params
            params = apply_masks_to_params(params, masks)
        return params, opt_state, loss

    graph_shardings = Graph(
        x=bsh, senders=bsh, receivers=bsh, y=bsh,
        node_mask=bsh, edge_mask=bsh, node_y=bsh if has_node_y else None,
    )
    return jax.jit(
        step,
        in_shardings=(rep, rep, graph_shardings),
        out_shardings=(rep, rep, rep),
        donate_argnums=(0, 1) if donate else (),
    )


def make_dp_eval_step(logits_fn: Callable, mesh: Mesh,
                      cfg: TrainConfig = TrainConfig(), masks=None,
                      has_node_y: bool = False):
    loss_fn = make_dp_loss_fn(logits_fn, cfg, masks)
    rep = NamedSharding(mesh, P())
    bsh = NamedSharding(mesh, P(mesh_lib.DATA_AXIS))
    graph_shardings = Graph(x=bsh, senders=bsh, receivers=bsh, y=bsh,
                            node_mask=bsh, edge_mask=bsh,
                            node_y=bsh if has_node_y else None)
    return jax.jit(loss_fn, in_shardings=(rep, graph_shardings),
                   out_shardings=rep)
