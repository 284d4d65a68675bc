"""Useful-FLOP accounting and MFU (model FLOP utilisation) for the bench.

"Useful" FLOPs are the *sparse-equivalent* work of the model — the edge
MLP, node MLP, input/output nets, and one multiply+add per edge per
aggregation direction — independent of the aggregation layout actually
executed.  The dense one-hot incidence path (`ops/dense_incidence.py`)
executes ~V/2 matmul FLOPs per useful gather/scatter FLOP (structural
zeros); the blocked path ~bn/2.  Reporting edges/s alone hides that
amplification: MFU = useful FLOPs / device peak says whether a path is
*kernel-efficient* rather than merely dispatch-amortised.

Reference model: `/root/reference/gnn/model.py:127-156` — input MLP,
n_iters x (edge net `model.py:36-81` -> node net `model.py:84-125`),
final edge net.
"""

from __future__ import annotations


def segment_classifier_flops(
    n_node: float,
    n_edge: float,
    hidden_dim: int,
    n_iters: int,
    input_dim: int = 2,
) -> float:
    """Useful forward-pass FLOPs of one SegmentClassifier application.

    Counts 2 FLOPs per MAC in every MLP matmul and 4 FLOPs per edge per
    hidden dim for the two weighted aggregations (multiply by the edge
    weight + accumulate, both directions); gathers count as bytes, not
    FLOPs.  ``n_node``/``n_edge`` are REAL (mask-summed) counts.
    """
    v, e, h, d_in = float(n_node), float(n_edge), hidden_dim, input_dim
    d = h + d_in                      # shortcut-concat width [H, X]
    edge_mlp = 2 * e * h * (2 * d + 1)          # [E,2D]@[2D,h] + [E,h]@[h,1]
    node_mlp = 2 * v * h * (3 * d + h)          # [V,3D]@[3D,h] + [V,h]@[h,h]
    agg = 4 * e * d                             # w*msg + accumulate, 2 dirs
    input_mlp = 2 * v * d_in * h
    return input_mlp + n_iters * (edge_mlp + agg + node_mlp) + edge_mlp


def train_step_flops(fwd_flops: float) -> float:
    """Training-step useful FLOPs: fwd + bwd ~= 3x fwd (the standard
    2-backward-matmuls-per-forward-matmul estimate; optimizer update is
    negligible at <30k params)."""
    return 3.0 * fwd_flops


# Published peaks per device, keyed by jax ``device_kind``: dense bf16
# tensor-core TFLOP/s (no sparsity) and HBM GB/s.  Source: NVIDIA H100
# Tensor Core GPU data sheet (SXM5: 989 TFLOP/s, 3.35 TB/s; PCIe: 756
# TFLOP/s, 2.0 TB/s).  Rates assume the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
    "NVIDIA H100 PCIe": {"bf16_tflops": 756.0, "hbm_gbps": 2000.0},
}


def device_peaks(device=None) -> dict:
    """Published peaks of ``device`` (default: first jax device).

    Raises ``KeyError`` for a ``device_kind`` not in :data:`PEAKS`: a
    utilisation against a guessed peak is not a measurement."""
    import jax

    if device is None:
        device = jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def mfu(useful_flops_per_s: float, device=None) -> float:
    """Fraction of the device's bf16 peak the useful FLOP rate represents."""
    return useful_flops_per_s / (device_peaks(device)["bf16_tflops"] * 1e12)
