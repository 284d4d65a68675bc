"""Training engine: jitted update step, optax optimiser, checkpoint/resume.

The JAX counterpart of the reference Estimator
(`/root/reference/gnn/estimator.py`):

- ``training_step`` (`estimator.py:49-60`): here a single jit-compiled
  function of (params, opt_state, batch) -> (params, opt_state, loss) with
  the L1 penalty on edge-/node-network weights (`estimator.py:54-57`)
  fused into the loss.
- ``fit_gen`` (`estimator.py:80-135`): epoch loop resumable from
  ``len(train_losses)``, per-epoch validation, checkpoint-every-epoch with
  best-model retention.
- ``predict`` (`estimator.py:137-146`).

Differences by design: loss is the numerically stable
sigmoid-BCE-on-logits, and padded edges are excluded from loss/metrics via
masks (the reference's padded batches silently include them).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gnn_fpga_jax.core.graph import Graph
from gnn_fpga_jax.train.checkpoint import CheckpointManager
from gnn_fpga_jax.train import metrics as metrics_lib


def logger(s: str) -> None:
    """Datetime-stamped print, as `estimator.py:18-20`."""
    from datetime import datetime
    print(datetime.now(), s, flush=True)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3        # torch.optim.Adam default
    optimizer: str = "adam"            # adam | sgd (reference supports both)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    l1: float = 0.0                    # L1 coeff on edge/node net weights
    target: str = "edge"               # edge -> graph.y ; node -> graph.node_y
    loss_masking: bool = True
    pos_weight: float = 1.0            # BCE weight on positive targets —
    # at mu200-scale edge imbalance (~1:40 true:false) unweighted BCE
    # collapses to the base rate exactly as the reference's does
    # (`MPNN_Seg_ACTS_mu200.ipynb:cell26`: recall 0.042); pos_weight ~
    # n_neg/n_pos restores the gradient signal.
    # Learning-rate schedule (the reference trains constant-lr Adam,
    # `estimator.py:33-36`; cosine decay is what the reference-scale
    # convergence gates use to reach the plateau in
    # bounded epochs): "constant" | "cosine".
    lr_schedule: str = "constant"
    decay_steps: int = 0               # cosine: steps to decay over
    lr_min_fraction: float = 0.01      # cosine: final lr / initial lr


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    lr = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        if cfg.decay_steps <= 0:
            raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
        lr = optax.cosine_decay_schedule(cfg.learning_rate, cfg.decay_steps,
                                         alpha=cfg.lr_min_fraction)
    elif cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.optimizer == "adam":
        return optax.adam(lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    if cfg.optimizer == "sgd":
        return optax.sgd(lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def l1_penalty(params, modules=("edge", "node"), masks=None) -> jax.Array:
    """Sum of |W| over the weight matrices of the given sub-networks —
    matches `estimator.py:49-57` (weights only, biases excluded).

    With ``masks`` given, pruned positions are excluded: unlike torch, JAX's
    subgradient of |w| at 0 is 1, which would push pruned weights off zero.
    """
    total = jnp.asarray(0.0, jnp.float32)
    for mod in modules:
        if mod not in params:
            continue
        for name, layer in params[mod].items():
            if isinstance(layer, dict) and "w" in layer:
                w = layer["w"]
                if masks is not None and mod in masks and masks[mod].get(name) is not None:
                    w = w * masks[mod][name]
                total = total + jnp.abs(w).sum()
    return total


def masked_bce_with_logits(logits, targets, mask, pos_weight: float = 1.0):
    """Mean sigmoid BCE over unmasked elements, with optional positive-class
    weighting (torch's ``BCEWithLogitsLoss(pos_weight=...)`` semantics)."""
    per = optax.sigmoid_binary_cross_entropy(logits, targets)
    if pos_weight != 1.0:
        w = jnp.where(targets > 0.5, pos_weight, 1.0)
        per = per * w
    if mask is None:
        return per.mean()
    denom = jnp.maximum(mask.sum(), 1.0)
    return (per * mask).sum() / denom


def stack_batches(batches: Sequence[Graph]) -> Graph:
    """Stack same-shape batches along a new leading axis for
    :meth:`Trainer.run_steps` (scan axis = optimizer steps)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *batches)


def _maybe_vmap(fn, graph: Graph):
    """Apply a single-graph function over an optional leading batch axis."""
    if graph.x.ndim == 3:
        return jax.vmap(fn)
    return fn


class Trainer:
    """Functional training engine.

    Args:
      logits_fn: ``(params, graph, masks) -> logits`` for a single graph
        (edge logits ``[E]`` or node logits ``[N]`` per ``cfg.target``).
      params: initial parameter pytree.
      cfg: TrainConfig.
      masks: optional pruning-mask pytree (see compress/pruning.py).
      checkpoint_dir: directory for latest/best checkpoints; None disables.
      metrics_path: optional jsonl file appended with per-epoch records.
    """

    def __init__(
        self,
        logits_fn: Callable,
        params,
        cfg: TrainConfig = TrainConfig(),
        masks=None,
        checkpoint_dir: Optional[str] = None,
        metrics_path: Optional[str] = None,
        strategy: str = "single",
        mesh=None,
        model_cfg=None,
        exchange: str = "halo",
        unshared: bool = False,
    ):
        """``strategy`` selects the execution engine (same fit / run_steps /
        predict / evaluate / checkpoint semantics for all three):

        - ``"single"``: one device; ``logits_fn(params, graph, masks)``.
        - ``"dp"``: data parallel over ``mesh``'s ``data`` axis — batched
          Graphs are sharded on the batch axis, params replicated, the
          gradient all-reduce derived by GSPMD.
        - ``"partitioned"``: graph (context) parallel over ``mesh``'s
          ``graph`` axis — batches are
          :class:`~gnn_fpga_jax.parallel.partition.PartitionedGraph`s; the
          forward runs under shard_map with halo exchange.  Needs
          ``model_cfg`` (a SegmentClassifier/NodeClassifier config;
          ``logits_fn`` is unused on this path).
        """
        self.cfg = cfg
        # own copy: train steps donate their params/opt-state buffers, which
        # would otherwise invalidate arrays the caller (or a second Trainer
        # built from the same init) still holds.
        self.params = jax.tree.map(jnp.array, params)
        self.masks = masks
        self.optimizer = make_optimizer(cfg)
        self.opt_state = self.optimizer.init(params)
        self.train_losses: List[float] = []
        self.valid_losses: List[float] = []
        self.best_valid_loss = float("inf")
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.metrics_path = metrics_path
        self._logits_fn = logits_fn
        self.strategy = strategy
        self.mesh = mesh
        self._model_cfg = model_cfg
        self._exchange = exchange
        self._unshared = unshared
        if strategy == "single":
            self._build_steps()
        elif strategy == "dp":
            self._build_steps_dp()
        elif strategy == "partitioned":
            self._build_steps_partitioned()
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        from gnn_fpga_jax.models.mpnn import count_params
        logger("Parameters: %i" % count_params(params))

    # -- jitted functions --------------------------------------------------

    def _target_and_mask(self, graph: Graph):
        if self.cfg.target == "edge":
            return graph.y, (graph.edge_mask if self.cfg.loss_masking else None)
        if graph.node_y is None:
            raise ValueError("node target requested but graph.node_y is None")
        return graph.node_y, (graph.node_mask if self.cfg.loss_masking else None)

    def _build_steps(self):
        cfg = self.cfg
        logits_fn = self._logits_fn
        masks = self.masks
        optimizer = self.optimizer

        def loss_fn(params, graph: Graph):
            single = lambda g: logits_fn(params, g, masks)
            logits = _maybe_vmap(single, graph)(graph)
            targets, mask = self._target_and_mask(graph)
            loss = masked_bce_with_logits(logits, targets, mask,
                                          cfg.pos_weight)
            if cfg.l1:
                loss = loss + cfg.l1 * l1_penalty(params, masks=masks)
            return loss

        def train_step(params, opt_state, graph):
            loss, grads = jax.value_and_grad(loss_fn)(params, graph)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            if masks is not None:
                # Project back onto the mask: pruned weights stay exactly 0
                # (torch's MaskedLinear invariant, model_maskedlinear.py:19-30).
                from gnn_fpga_jax.compress.pruning import apply_masks_to_params
                params = apply_masks_to_params(params, masks)
            return params, opt_state, loss

        def eval_loss(params, graph):
            return loss_fn(params, graph)

        def predict_fn(params, graph):
            single = lambda g: logits_fn(params, g, masks)
            return jax.nn.sigmoid(_maybe_vmap(single, graph)(graph))

        def train_steps_scan(params, opt_state, stacked):
            # Many optimizer steps in ONE device dispatch: lax.scan over a
            # stacked pytree of batches.  At reference model sizes (<30k
            # params) a single step is short next to a host dispatch;
            # scanning an epoch amortises the dispatch.
            def body(carry, batch):
                params, opt_state = carry
                params, opt_state, loss = train_step(params, opt_state, batch)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), stacked)
            return params, opt_state, losses

        self._train_step = jax.jit(train_step, donate_argnums=(0, 1))
        self._train_steps = jax.jit(train_steps_scan, donate_argnums=(0, 1))
        self._eval_loss = jax.jit(eval_loss)
        self._predict = jax.jit(predict_fn)

    def _build_steps_dp(self):
        """Data-parallel steps: batch axis sharded over mesh 'data', params
        replicated; GSPMD derives the gradient all-reduce (SURVEY §2.3 —
        capability the reference lacks)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from gnn_fpga_jax.parallel import data_parallel as dp
        from gnn_fpga_jax.parallel import mesh as mesh_lib

        if self.mesh is None:
            raise ValueError("strategy='dp' needs a mesh")
        cfg, mesh, masks = self.cfg, self.mesh, self.masks
        logits_fn = self._logits_fn
        self._train_step = dp.make_dp_train_step(
            logits_fn, self.optimizer, mesh, cfg, masks)
        self._eval_loss = dp.make_dp_eval_step(logits_fn, mesh, cfg, masks)
        rep = NamedSharding(mesh, P())
        bsh = NamedSharding(mesh, P(mesh_lib.DATA_AXIS))
        stacked_sh = NamedSharding(mesh, P(None, mesh_lib.DATA_AXIS))

        def predict_fn(params, graph):
            logits = jax.vmap(lambda g: logits_fn(params, g, masks))(graph)
            return jax.nn.sigmoid(logits)

        self._predict = jax.jit(predict_fn, in_shardings=(rep, bsh))

        loss_fn = dp.make_dp_loss_fn(logits_fn, cfg, masks)
        self._train_steps = jax.jit(
            self._make_scan(loss_fn), donate_argnums=(0, 1),
            in_shardings=(rep, rep, stacked_sh),
            out_shardings=(rep, rep, rep))

    def _build_steps_partitioned(self):
        """Graph-parallel steps over mesh 'graph': batches are
        PartitionedGraphs; forward under shard_map with halo exchange
        (parallel/partition.py)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from gnn_fpga_jax.parallel import partition as part
        from gnn_fpga_jax.parallel import mesh as mesh_lib

        if self.mesh is None or self._model_cfg is None:
            raise ValueError("strategy='partitioned' needs mesh + model_cfg")
        mesh, cfg = self.mesh, self.cfg
        self._train_step = part.make_sharded_train_step(
            self.optimizer, mesh, self._model_cfg, l1=cfg.l1,
            masks=self.masks, exchange=self._exchange,
            target=cfg.target, unshared=self._unshared,
            pos_weight=cfg.pos_weight)
        fwd = part.make_sharded_forward(
            mesh, self._model_cfg, masks=self.masks,
            exchange=self._exchange, head=cfg.target,
            unshared=self._unshared)
        self._predict = lambda params, pg: jax.nn.sigmoid(fwd(params, pg))

        def eval_loss(params, pg):
            logits = fwd(params, pg)
            targets, mask = self._target_and_mask(pg)
            return masked_bce_with_logits(logits, targets, mask,
                                          cfg.pos_weight)

        self._eval_loss = eval_loss

        # scan-of-steps over stacked PartitionedGraphs
        rep = NamedSharding(mesh, P())
        stacked_sh = NamedSharding(mesh, P(None, mesh_lib.GRAPH_AXIS))
        step = self._train_step

        def scan_steps(params, opt_state, stacked):
            def body(carry, batch):
                params, opt_state = carry
                params, opt_state, loss = step(params, opt_state, batch)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), stacked)
            return params, opt_state, losses

        self._train_steps = jax.jit(
            scan_steps, donate_argnums=(0, 1),
            in_shardings=(rep, rep, stacked_sh),
            out_shardings=(rep, rep, rep))

    def _make_scan(self, loss_fn):
        optimizer, masks = self.optimizer, self.masks

        def train_steps_scan(params, opt_state, stacked):
            def body(carry, batch):
                params, opt_state = carry
                loss, grads = jax.value_and_grad(loss_fn)(params, batch)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = optax.apply_updates(params, updates)
                if masks is not None:
                    from gnn_fpga_jax.compress.pruning import \
                        apply_masks_to_params
                    params = apply_masks_to_params(params, masks)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), stacked)
            return params, opt_state, losses

        return train_steps_scan

    # -- public API --------------------------------------------------------

    @property
    def epoch(self) -> int:
        return len(self.train_losses)

    def fit(
        self,
        train_generator: Iterator[Graph],
        n_batches: int,
        n_epochs: int,
        valid_generator: Optional[Iterator[Graph]] = None,
        n_valid_batches: int = 0,
        verbose: int = 0,
    ) -> None:
        """Epoch loop with resume semantics of `estimator.py:80-135`."""
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            logger("Epoch %i" % i)
            t0 = time.perf_counter()
            sum_loss = 0.0
            for j in range(n_batches):
                batch = next(train_generator)
                self.params, self.opt_state, loss = self._train_step(
                    self.params, self.opt_state, batch)
                loss = float(loss)
                sum_loss += loss
                if verbose > 0:
                    logger("  Batch %i loss %f" % (j, loss))
            dt = time.perf_counter() - t0
            avg_loss = sum_loss / n_batches
            self.train_losses.append(avg_loss)
            logger("  training loss %.3g time %gs" % (avg_loss, dt))

            record = {"epoch": i, "train_loss": avg_loss, "time_s": dt}
            if valid_generator is not None and n_valid_batches > 0:
                vloss = float(np.mean([
                    float(self._eval_loss(self.params, next(valid_generator)))
                    for _ in range(n_valid_batches)]))
                self.valid_losses.append(vloss)
                logger("  validate loss %.3g" % vloss)
                record["valid_loss"] = vloss
                is_best = vloss < self.best_valid_loss
                self.best_valid_loss = min(vloss, self.best_valid_loss)
                self.save_checkpoint(is_best)
            elif self.ckpt is not None:
                self.save_checkpoint(False)
            self._write_metrics(record)

    def run_steps(self, stacked: Graph) -> np.ndarray:
        """Run one optimizer step per leading-axis slice of ``stacked`` in a
        single device dispatch (``lax.scan`` inside jit).

        ``stacked`` is a pytree of batches stacked along a new leading axis
        (see :func:`stack_batches`).  Returns the per-step losses.  This is
        the scan-based inner loop — the Python-level ``fit`` loop costs
        one host round-trip per *step*; this costs one per *epoch*.
        """
        self.params, self.opt_state, losses = self._train_steps(
            self.params, self.opt_state, stacked)
        return np.asarray(losses)

    def fit_stacked(
        self,
        train_epoch: Graph,
        n_epochs: int,
        valid_batch: Optional[Graph] = None,
        verbose: int = 0,
    ) -> None:
        """`fit` over a fixed stacked epoch of batches — one dispatch per
        epoch via :meth:`run_steps`, same checkpoint/metrics semantics."""
        epoch_start = self.epoch
        for i in range(epoch_start, epoch_start + n_epochs):
            t0 = time.perf_counter()
            losses = self.run_steps(train_epoch)
            dt = time.perf_counter() - t0
            avg_loss = float(losses.mean())
            self.train_losses.append(avg_loss)
            if verbose > 0:
                logger("Epoch %i training loss %.3g time %gs" % (i, avg_loss, dt))
            record = {"epoch": i, "train_loss": avg_loss, "time_s": dt}
            if valid_batch is not None:
                vloss = float(self._eval_loss(self.params, valid_batch))
                self.valid_losses.append(vloss)
                record["valid_loss"] = vloss
                is_best = vloss < self.best_valid_loss
                self.best_valid_loss = min(vloss, self.best_valid_loss)
                self.save_checkpoint(is_best)
            elif self.ckpt is not None:
                self.save_checkpoint(False)
            self._write_metrics(record)

    def predict(self, generator: Iterator[Graph], n_batches: int,
                concat: bool = True):
        """Sigmoid probabilities over n_batches (`estimator.py:137-146`);
        returns (preds, targets, masks) flattened when ``concat``."""
        preds, targets, masks = [], [], []
        for _ in range(n_batches):
            g = next(generator)
            p = np.asarray(self._predict(self.params, g))
            t, m = self._target_and_mask(g)
            preds.append(p.ravel())
            targets.append(np.asarray(t).ravel())
            masks.append(np.ones_like(p).ravel() if m is None
                         else np.asarray(m).ravel())
        if concat:
            return (np.concatenate(preds), np.concatenate(targets),
                    np.concatenate(masks))
        return preds, targets, masks

    def evaluate(self, generator: Iterator[Graph], n_batches: int,
                 threshold: float = 0.5):
        """accuracy/precision/recall/AUC as `trainSegmentClassifier.py:186-190`."""
        p, t, m = self.predict(generator, n_batches)
        return metrics_lib.binary_metrics(p, t, m, threshold)

    # -- checkpointing -----------------------------------------------------

    def _arrays(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _meta(self):
        return {
            "epoch": self.epoch,
            "best_valid_loss": self.best_valid_loss,
            "train_losses": [float(x) for x in self.train_losses],
            "valid_losses": [float(x) for x in self.valid_losses],
        }

    def save_checkpoint(self, is_best: bool) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self._arrays(), self._meta(), is_best)

    def load_checkpoint(self, best: bool = False) -> bool:
        """Restore params/opt state/histories (`estimator.py:73-78`)."""
        if self.ckpt is None or not self.ckpt.exists(best):
            return False
        arrays, meta = self.ckpt.restore(self._arrays(), best)
        self.params = jax.tree.map(jnp.asarray, arrays["params"])
        self.opt_state = jax.tree.map(jnp.asarray, arrays["opt_state"])
        self.best_valid_loss = float(meta["best_valid_loss"])
        self.train_losses = list(meta["train_losses"])
        self.valid_losses = list(meta["valid_losses"])
        return True

    def load_weights(self, params, apply_masks: bool = True):
        """Mask-aware weight transplant for pruning rounds
        (`estimator_maskedlinear.py:81-101`): copy ``params`` in, zeroing
        masked-out weights so they stay zero under masked gradients."""
        from gnn_fpga_jax.compress.pruning import apply_masks_to_params
        self.params = (apply_masks_to_params(params, self.masks)
                       if (apply_masks and self.masks is not None) else params)
        self.opt_state = self.optimizer.init(self.params)

    def _write_metrics(self, record) -> None:
        if not self.metrics_path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)),
                    exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
