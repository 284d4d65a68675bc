#!/usr/bin/env python3
"""Bring-up check: the segment classifier's main path, end to end, on GPUs.

Run from the root of a checkout:

    python chip_smoke.py          # one GPU: phases 0-3
    python chip_smoke.py --four   # four GPUs: phase 0, then only the
                                  # dp and partitioned train steps

Everything runs in this one process, which drives every card.  A failing
phase raises, so the process exits non-zero before the last line; the
last line is printed only after every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases, at the mu200 model width (hidden 64, 6 iterations, input dim 2,
`MPNN_Seg_ACTS_mu200.ipynb:cell15`) with random weights from a seed:

0. device — JAX's first device must be a GPU (no CPU fallback); prints
   the device, JAX version, XLA_FLAGS, the compile-cache directory and
   the card's name and power limit.
1. parity — logits and parameter gradients of every aggregation route
   (sparse, dense, blocked) on 16 mu200 sectors against the float64
   oracle of `tests/oracle.py`, at three precisions; then the 36-sector
   fullevent batch on sparse and blocked against the same function on
   the host CPU.
2. front door — the train CLI (blocked, bf16) on 64 NPZ graphs, a
   resume from its checkpoint, and the infer CLI's latency benchmark.
3. scan path — one `Trainer.run_steps` scan over 32 distinct batches
   (blocked, bf16, the `bench.py` path): compiled memory analysis and
   ms/step, printed as information only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from gnn_fpga_jax.core import graph as graph_lib
from gnn_fpga_jax.data import toy2d
from gnn_fpga_jax.models import mpnn
from gnn_fpga_jax.ops import blocked as blk
from gnn_fpga_jax.train.trainer import (TrainConfig, Trainer,
                                        masked_bce_with_logits,
                                        stack_batches)
from gnn_fpga_jax.utils.compile_cache import enable_compile_cache
from gnn_fpga_jax.utils.device import card_name_and_power_limit, require_gpu

ROUTES = ("sparse", "dense", "blocked")

# --- tolerances -----------------------------------------------------------
# f32 with every matmul at "highest" precision: only summation order
# differs from the float64 oracle.
TOL_PROB_HIGHEST = 1e-4        # max |p - p_oracle| over real edges
TOL_GRAD_HIGHEST = 1e-3        # per leaf: max|g - g_ref| / max|g_ref|
# f32 at default precision: the card may run f32 matmuls as TF32 (~3
# significant digits), and the one-hot matmuls of dense and blocked then
# round the gathered features themselves.
TOL_PROB_DEFAULT = 1e-2
# bf16 compute (f32 master weights), as training runs: ~3 digits in
# every activation, compounded over the iterations.
TOL_PROB_BF16 = 3e-2
# --four: the same f32 "highest" step on 4 cards and on 1; the
# collectives only reorder sums.
TOL_LOSS_FOUR = 1e-4           # relative, per step


@dataclasses.dataclass(frozen=True)
class Size:
    """Shapes of every phase.  The defaults are the real ones; the tests
    run the same phases at a tiny size on the CPU."""
    hidden: int = 64
    n_iters: int = 6
    n_layers: int = 20          # mu200 sector: 20 layers x 22 tracks
    n_tracks: int = 22
    k: int = 12                 # kNN window: E = 19 * 22 * 12 = 5016
    group: int = 4              # blocked: layer pairs per block
    n_graphs: int = 16          # sectors per batch
    n_sectors: int = 36         # fullevent: V ~ 15.8k, E ~ 180k
    n_npz: int = 64             # NPZ graphs for the CLI
    n_epochs: int = 3
    scan_steps: int = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def sectors(size: Size, n: int, seed: int):
    """``n`` seeded mu200-like sectors as one batched Graph + its config."""
    cfg = toy2d.Toy2DConfig(n_layers=size.n_layers, n_tracks=size.n_tracks,
                            seed=seed)
    return toy2d.make_knn_segment_graphs(cfg, n, k=size.k), cfg


def with_blocks(size: Size, g, cfg):
    return blk.attach_blocks_layered(g, toy2d.layer_offsets(cfg),
                                     group=size.group)


def model_cfg(size: Size, aggregation: str, compute_dtype=None):
    return mpnn.SegmentClassifierConfig(
        input_dim=2, hidden_dim=size.hidden, n_iters=size.n_iters,
        aggregation=aggregation, compute_dtype=compute_dtype)


def loss_and_probs(params, graph, cfg):
    """Masked mean BCE over all real edges, and the edge probabilities."""
    fn = lambda g: mpnn.segment_classifier_logits(params, g, cfg)
    logits = jax.vmap(fn)(graph) if graph.x.ndim == 3 else fn(graph)
    loss = masked_bce_with_logits(logits, graph.y, graph.edge_mask)
    return loss, jax.nn.sigmoid(logits)


def run_on(device, params, graph, cfg):
    """(loss, probs, grads) of ``cfg``'s route, computed on ``device``."""
    step = jax.jit(jax.value_and_grad(loss_and_probs, has_aux=True),
                   static_argnums=2)
    params, graph = jax.device_put((params, graph), device)
    (loss, probs), grads = step(params, graph, cfg)
    return jax.tree.map(np.asarray, (loss, probs, grads))


def grad_rel_err(grads, ref) -> float:
    """Worst leaf of max|g - ref| / max|ref|."""
    errs = jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max()
                           / max(np.abs(b).max(), 1e-30)), grads, ref)
    return max(jax.tree.leaves(errs))


def load_oracle():
    """``tests/oracle.py`` of this checkout, imported by path (a package
    named ``tests`` elsewhere on the path must not shadow it)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "oracle.py")
    spec = importlib.util.spec_from_file_location("gnn_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def oracle_reference(params, graph, n_iters):
    """Float64 oracle (`tests/oracle.py`) on a batched graph: edge
    probabilities from NumPy, and parameter gradients of the masked BCE
    from the same formulas traced by JAX in float64 on the host CPU."""
    oracle = load_oracle()
    incid = [graph_lib.to_dense_incidence(g)
             for g in graph_lib.unbatch_graphs(graph)]
    x, ri, ro = (np.stack([i[j] for i in incid]).astype(np.float64)
                 for j in range(3))
    probs = np.stack([
        oracle.segment_classifier_dense(params, x[b], ri[b], ro[b], n_iters)
        for b in range(len(incid))])
    grads = oracle.segment_classifier_bce_grads(
        params, x, ri, ro, graph.y, graph.edge_mask, n_iters)
    return probs, grads


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(four: bool = False) -> None:
    """Phase 0: refuse anything but a GPU; print what the run is on."""
    require_gpu()
    devices = jax.devices()
    if four and len(devices) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found "
                         f"{len(devices)}")
    cache = enable_compile_cache()
    log(f"device: kind={devices[0].device_kind!r} count={len(devices)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f" compile_cache={cache}")
    log(f"card (nvidia-smi name, power.limit): "
        f"{card_name_and_power_limit()}")


def phase_parity(size: Size, device, seed: int = 0) -> None:
    """Phase 1: every route against the float64 oracle at three
    precisions, then fullevent on the card against the host CPU."""
    g, cfg = sectors(size, size.n_graphs, seed)
    # the blocked plan permutes and pads the edges; every route and the
    # oracle run on that one graph, so their edges line up
    g = with_blocks(size, g, cfg)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(seed),
                                          model_cfg(size, "sparse"))
    t0 = time.perf_counter()
    ref_probs, ref_grads = oracle_reference(params, g, size.n_iters)
    log(f"phase1 oracle: {g.x.shape[0]} graphs x {g.n_node} nodes x "
        f"{g.n_edge} edge slots ({time.perf_counter() - t0:.1f} s)")
    real = np.asarray(g.edge_mask) > 0

    for route in ROUTES:
        modes = (
            ("f32-highest", None, "highest", TOL_PROB_HIGHEST),
            ("f32-default", None, None, TOL_PROB_DEFAULT),
            ("bf16", jnp.bfloat16, None, TOL_PROB_BF16),
        )
        for name, dtype, precision, tol in modes:
            cfg_r = model_cfg(size, route, dtype)
            with jax.default_matmul_precision(precision):
                loss, probs, grads = run_on(device, params, g, cfg_r)
            dp = float(np.abs(probs - ref_probs)[real].max())
            dg = grad_rel_err(grads, ref_grads)
            log(f"phase1 {route:7s} {name:11s}: loss={float(loss):.6f} "
                f"max|dp|={dp:.3e} (tol {tol:g}) grad_rel={dg:.3e}"
                + (f" (tol {TOL_GRAD_HIGHEST:g})" if precision else ""))
            if not np.isfinite(float(loss)) or not dp <= tol:
                raise AssertionError(
                    f"{route} {name}: max|dp| {dp:.3e} > {tol:g}")
            if precision == "highest" and not dg <= TOL_GRAD_HIGHEST:
                raise AssertionError(
                    f"{route} {name}: grad rel err {dg:.3e} > "
                    f"{TOL_GRAD_HIGHEST:g}")

    # fullevent: too large for the dense oracle; the same function on the
    # host CPU is the reference
    gs, cfg_f = sectors(size, size.n_sectors, seed + 1)
    layouts = {
        "sparse": graph_lib.pack_graphs(graph_lib.unbatch_graphs(gs)),
        "blocked": with_blocks(size, gs, cfg_f),
    }
    cpu = jax.devices("cpu")[0]
    for route, gf in layouts.items():
        cfg_r = model_cfg(size, route)
        with jax.default_matmul_precision("highest"):
            loss, probs, grads = run_on(device, params, gf, cfg_r)
            c_loss, c_probs, c_grads = run_on(cpu, params, gf, cfg_r)
        m = np.asarray(gf.edge_mask) > 0
        dp = float(np.abs(probs - c_probs)[m].max())
        dg = grad_rel_err(grads, c_grads)
        log(f"phase1 fullevent {route:7s}: V={int(np.sum(gf.node_mask))} "
            f"E={int(m.sum())} loss={float(loss):.6f} "
            f"cpu={float(c_loss):.6f} max|dp|={dp:.3e} "
            f"(tol {TOL_PROB_HIGHEST:g}) grad_rel={dg:.3e} "
            f"(tol {TOL_GRAD_HIGHEST:g})")
        if not (dp <= TOL_PROB_HIGHEST and dg <= TOL_GRAD_HIGHEST):
            raise AssertionError(f"fullevent {route}: device vs CPU "
                                 f"dp={dp:.3e} grad_rel={dg:.3e}")


def write_npz_graphs(size: Size, directory: str, seed: int = 100) -> None:
    """``size.n_npz`` seeded sectors as NPZ files with per-node layers."""
    g, cfg = sectors(size, size.n_npz, seed)
    layer = np.repeat(np.arange(cfg.n_layers), cfg.n_tracks)
    for i, gi in enumerate(graph_lib.unbatch_graphs(g)):
        graph_lib.save_npz(gi, os.path.join(directory, f"g{i:04d}.npz"),
                           layer=layer)


def phase_front_door(size: Size) -> None:
    """Phase 2: train CLI (blocked, bf16), resume, infer CLI benchmark."""
    import logging

    from gnn_fpga_jax.cli import infer, train

    # CLI progress goes to stdout with this script's own lines
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "graphs"), os.path.join(tmp, "run")
        os.makedirs(data)
        write_npz_graphs(size, data)
        common = [
            "--input-dir", data, "--output-dir", out,
            "--aggregation", "blocked", "--group", str(size.group), "--bf16",
            "--hidden-dim", str(size.hidden), "--n-iters", str(size.n_iters),
            "--batch-size", str(size.n_graphs),
            "--valid-frac", "0.25", "--test-frac", "0.0",
            "--learning-rate", "3e-3", "--pos-weight", "8"]
        tr = train.main(common + ["--n-epochs", str(size.n_epochs)])
        losses = list(tr.train_losses)
        log(f"phase2 train losses per epoch: {losses}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train CLI losses not finite and falling: "
                                 f"{losses}")
        tr2 = train.main(common + ["--n-epochs", "1", "--resume"])
        log(f"phase2 resumed: epoch {tr2.epoch}, losses {tr2.train_losses}")
        if tr2.epoch != size.n_epochs + 1 or tr2.train_losses[:-1] != losses:
            raise AssertionError("resume did not restore the run's history")
        res = infer.main(["--model", os.path.join(out, "model.npz"),
                          "--input-dir", data, "--n-graphs", "4",
                          "--hidden-dim", str(size.hidden),
                          "--n-iters", str(size.n_iters), "--benchmark"])
        scores = [r["mean_score"] for r in res]
        log(f"phase2 infer mean scores: {scores}")
        if not all(0.0 <= s <= 1.0 for s in scores):
            raise AssertionError(f"infer scores out of range: {scores}")


def phase_scan(size: Size, seed: int = 200) -> None:
    """Phase 3: one run_steps scan of distinct batches, blocked bf16."""
    cfg = model_cfg(size, "blocked", jnp.bfloat16)
    params = mpnn.init_segment_classifier(jax.random.PRNGKey(seed), cfg)
    tr = Trainer(lambda p, g, m: mpnn.segment_classifier_logits(p, g, cfg, m),
                 params, TrainConfig(learning_rate=3e-3, pos_weight=8.0))
    # every kNN sector has the same block shapes, so the batches stack
    stacked = stack_batches([
        with_blocks(size, *sectors(size, size.n_graphs, seed + s))
        for s in range(size.scan_steps)])
    compiled = tr._train_steps.lower(tr.params, tr.opt_state,
                                     stacked).compile()
    log(f"phase3 memory_analysis: {compiled.memory_analysis()}")
    tr.run_steps(stacked)                       # compile + warm
    t0 = time.perf_counter()
    losses = tr.run_steps(stacked)              # host readback syncs
    dt = time.perf_counter() - t0
    log(f"phase3 scan: {size.scan_steps} steps, "
        f"{dt / size.scan_steps * 1e3:.3f} ms/step (information only, "
        f"not a benchmark)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"scan losses not finite: {losses}")


def phase_four(size: Size, devices, seed: int = 300) -> None:
    """--four: the dp and partitioned train steps on four devices, each
    against the one-device step on the same batch (f32, "highest")."""
    from gnn_fpga_jax.parallel import mesh as mesh_lib
    from gnn_fpga_jax.parallel import partition as part

    devs = list(devices)[:4]
    tcfg = TrainConfig(learning_rate=1e-3)

    def losses_of(cfg, strategy, mesh, stacked):
        params = mpnn.init_segment_classifier(jax.random.PRNGKey(seed), cfg)
        with jax.default_device(devs[0]):
            tr = Trainer(
                lambda p, g, m: mpnn.segment_classifier_logits(p, g, cfg, m),
                params, tcfg, strategy=strategy, mesh=mesh, model_cfg=cfg)
            return tr.run_steps(stacked)

    def check(name, four, one):
        rel = float(np.max(np.abs(four - one) / np.abs(one)))
        log(f"four {name}: 4-device losses {four.tolist()} 1-device "
            f"{one.tolist()} rel={rel:.3e} (tol {TOL_LOSS_FOUR:g})")
        if not (np.isfinite(four).all() and rel <= TOL_LOSS_FOUR):
            raise AssertionError(f"{name}: 4-device loss off by {rel:.3e}")

    with jax.default_matmul_precision("highest"):
        # dp: a batch of sectors, blocked route, batch axis over 4 devices
        g, cfg = sectors(size, size.n_graphs, seed)
        g = with_blocks(size, g, cfg)
        stacked = stack_batches([g, g])
        cfg_b = model_cfg(size, "blocked")
        dp_mesh = mesh_lib.make_mesh((4,), (mesh_lib.DATA_AXIS,),
                                     devices=devs)
        check("dp", losses_of(cfg_b, "dp", dp_mesh, stacked),
              losses_of(cfg_b, "single", None, stacked))

        # partitioned: one connected graph (the batch's tracks in one
        # event), halo-partitioned over 4 devices, vs sparse on one
        big, _ = sectors(dataclasses.replace(
            size, n_tracks=size.n_tracks * size.n_graphs), 1, seed + 1)
        big = jax.tree.map(lambda a: a[0], big)
        pg = part.partition_graph(big, 4)
        log(f"four partitioned: V={big.n_node} E={big.n_edge} "
            f"halo/pair={pg.halo_size}")
        cfg_s = model_cfg(size, "sparse")
        g_mesh = mesh_lib.make_mesh((4,), (mesh_lib.GRAPH_AXIS,),
                                    devices=devs)
        check("partitioned",
              losses_of(cfg_s, "partitioned", g_mesh,
                        stack_batches([pg, pg])),
              losses_of(cfg_s, "single", None, stack_batches([big, big])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the dp and partitioned train steps on "
                         "four GPUs, each against one GPU")
    args = ap.parse_args(argv)
    phase_device(args.four)
    devices = jax.devices()
    size = Size()
    if args.four:
        phase_four(size, devices)
    else:
        phase_parity(size, devices[0])
        phase_front_door(size)
        phase_scan(size)
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
