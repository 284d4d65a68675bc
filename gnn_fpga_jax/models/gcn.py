"""Graph-convolutional model family on dense adjacencies.

JAX re-design of the GCN workloads in
`/root/reference/gnn/GCN_Toy2D.ipynb` (cells 2,7-9: GraphConv,
GraphConvSelfInt, GCNBinaryClassifier, GCRNBinaryClassifier) and the
dual-graph segment classifier of `GCN_Seg_Toy2D.ipynb` (cells 3,8-15).

These workloads use small fixed-size graphs (layers x tracks nodes), so the
dense batched form ``A @ X @ W`` is the right layout for matmul units — batched
matmuls with fused relu epilogues, no gather/scatter.  All models are pure
functions over parameter pytrees; batching is a leading axis on (x, a)
handled by ordinary matmul broadcasting (no vmap needed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Adjacency construction & normalisation (vectorised, no per-event loops)
# ---------------------------------------------------------------------------

def layer_adjacency(l: np.ndarray) -> np.ndarray:
    """Binary adjacency connecting all hits on adjacent layers
    (`GCN_Seg_Toy2D.ipynb:cell3` calc_hit_adjacency).  ``l``: [B, N]."""
    return (np.abs(l[:, None, :] - l[:, :, None]) == 1).astype(np.float32)


def toy_adjacency(x: np.ndarray, r: np.ndarray, l: np.ndarray,
                  y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Toy-detector adjacency with entry/exit line constraints and the true
    adjacency (`GCN_Toy2D.ipynb:cell2` calc_adjacency): hits on adjacent
    layers are connected iff the straight line through them enters and
    exits the detector within the active area [0, 1)."""
    adj_l = layer_adjacency(l)
    dx = x[:, None, :] - x[:, :, None]
    dr = r[:, None, :] - r[:, :, None]
    dr = np.where(dr == 0, 1e-7, dr)
    slope = dx / dr
    rn = r.max()
    x0 = x[:, None, :] - slope * r[:, None, :]
    xn = x[:, None, :] + slope * (rn - r[:, None, :])
    adj = adj_l * ((x0 < 1) & (x0 > 0)) * ((xn < 1) & (xn > 0))
    adj_y = (y[:, None, :] == y[:, :, None]) * adj_l
    return adj.astype(np.float32), adj_y.astype(np.float32)


def row_norm_adjacency(a: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Rows normalised to sum 1 (`GCN_Toy2D.ipynb:cell2` norm_adjacency),
    as one broadcasted divide instead of per-event diagflat dots."""
    d = a.sum(axis=-1, keepdims=True)
    return (a / np.maximum(d, eps)).astype(np.float32)


def kipf_welling_adjacency(a: np.ndarray) -> np.ndarray:
    """Symmetric normalisation with self-loops
    D^-1/2 (A + I) D^-1/2 (`GCN_Toy2D.ipynb:cell2` kwnorm_adjacency)."""
    n = a.shape[-1]
    ahat = a + np.eye(n, dtype=a.dtype)[None]
    dinv = 1.0 / np.sqrt(ahat.sum(axis=-1))
    return (dinv[:, :, None] * ahat * dinv[:, None, :]).astype(np.float32)


# ---------------------------------------------------------------------------
# Line-graph (dual-graph) transform: segments as nodes
# ---------------------------------------------------------------------------

def segment_indices(hit_adj: np.ndarray) -> np.ndarray:
    """Upper-triangular nonzeros of the hit adjacency -> per-event segment
    endpoint index pairs [B, S, 2] (`GCN_Seg_Toy2D.ipynb:cell8`).  Assumes
    a constant segment count per event (toy data guarantee)."""
    b = hit_adj.shape[0]
    ev, i, j = np.nonzero(np.triu(hit_adj))
    return np.stack([i, j], axis=-1).reshape(b, -1, 2)


def segment_adjacency(seg_idx: np.ndarray) -> np.ndarray:
    """Segments adjacent iff one's middle hit is the other's start —
    vectorised over the reference's triple loop
    (`GCN_Seg_Toy2D.ipynb:cell10`), symmetrised."""
    share = (seg_idx[:, :, None, 1] == seg_idx[:, None, :, 0])
    return np.maximum(share, share.transpose(0, 2, 1)).astype(np.float32)


def segment_labels(hit_y: np.ndarray, seg_idx: np.ndarray) -> np.ndarray:
    """Segment truth: both endpoints same track (`cell11`)."""
    ev = np.arange(hit_y.shape[0])[:, None, None]
    seg_hit_y = hit_y[ev, seg_idx]
    return (seg_hit_y[:, :, 0] == seg_hit_y[:, :, 1]).astype(np.float32)


def segment_slopes(hit_x: np.ndarray, hit_r: np.ndarray,
                   seg_idx: np.ndarray) -> np.ndarray:
    """Per-segment dx/dr slope (`cell12`)."""
    ev = np.arange(hit_x.shape[0])[:, None, None]
    sx = hit_x[ev, seg_idx]
    sr = hit_r[ev, seg_idx]
    return ((sx[:, :, 1] - sx[:, :, 0])
            / (sr[:, :, 1] - sr[:, :, 0])).astype(np.float32)


def gaussian_slope_kernel(seg_slope: np.ndarray, sigma: float = 0.01) -> np.ndarray:
    """Edge weights from slope agreement: exp(-dslope^2 / 2 sigma^2)
    (`cell3` gaus_kernel + `cell13,15`)."""
    ds = seg_slope[:, None, :] - seg_slope[:, :, None]
    return np.exp(-(ds ** 2) / (2 * sigma ** 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# Graph-conv layers (pure functions)
# ---------------------------------------------------------------------------

def _init_linear(key, in_dim, out_dim, dtype=jnp.float32, bias=True):
    kw, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(jnp.asarray(in_dim, jnp.float32))
    p = {"w": jax.random.uniform(kw, (in_dim, out_dim), dtype, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_dim,), dtype, -bound, bound)
    return p


def _linear(p, x):
    out = x @ p["w"]
    return out + p["b"] if "b" in p else out


def init_graph_conv(key, in_dim, out_dim, dtype=jnp.float32):
    """A X W + b (`GCN_Toy2D.ipynb:cell7` GraphConv)."""
    return {"linear": _init_linear(key, in_dim, out_dim, dtype)}


def graph_conv(p, x, a):
    return _linear(p["linear"], a @ x)


def init_graph_conv_self_int(key, in_dim, out_dim, dtype=jnp.float32):
    """X W1 + A X W2 + b, self-interaction separated
    (`GCN_Toy2D.ipynb:cell7` GraphConvSelfInt; neighbour term bias-free)."""
    k1, k2 = jax.random.split(key)
    return {"node": _init_linear(k1, in_dim, out_dim, dtype),
            "neighbor": _init_linear(k2, in_dim, out_dim, dtype, bias=False)}


def graph_conv_self_int(p, x, a):
    return _linear(p["node"], x) + _linear(p["neighbor"], a @ x)


_GC_KINDS = {
    "conv": (init_graph_conv, graph_conv),
    "self_int": (init_graph_conv_self_int, graph_conv_self_int),
}


# ---------------------------------------------------------------------------
# Classifiers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GCNConfig:
    input_dim: int = 3
    hidden_dims: Tuple[int, ...] = (8, 8, 8)
    gc_kind: str = "self_int"     # conv | self_int
    residual: bool = False        # GCRN: concat input features per layer
    activation: Callable = jax.nn.relu
    dtype: Any = jnp.float32


def init_gcn_classifier(key, cfg: GCNConfig):
    """GCN(/GCRN)BinaryClassifier params (`GCN_Toy2D.ipynb:cell8-9`):
    feature extractor -> graph-conv stack -> per-node classifier head."""
    init_gc, _ = _GC_KINDS[cfg.gc_kind]
    dims = list(cfg.hidden_dims)
    keys = jax.random.split(key, len(dims) + 1)
    extra = cfg.input_dim if cfg.residual else 0
    return {
        "extract": _init_linear(keys[0], cfg.input_dim, dims[0], cfg.dtype),
        "gc": [init_gc(keys[i + 1], dims[i] + extra, dims[i + 1], cfg.dtype)
               for i in range(len(dims) - 1)],
        "head": _init_linear(keys[-1], dims[-1], 1, cfg.dtype),
    }


def gcn_classifier_logits(params, x, a, cfg: GCNConfig):
    """Per-node logits.  ``x``: [..., N, F], ``a``: [..., N, N] (normalised
    adjacency).  Residual mode concatenates the raw input features before
    every graph conv (`cell9` GCRN forward)."""
    act = cfg.activation
    _, gc_fn = _GC_KINDS[cfg.gc_kind]
    h = act(_linear(params["extract"], x))
    for p in params["gc"]:
        if cfg.residual:
            h = jnp.concatenate([h, x], axis=-1)
        h = act(gc_fn(p, h, a))
    return _linear(params["head"], h)[..., 0]


def gcn_classifier(params, x, a, cfg: GCNConfig):
    return jax.nn.sigmoid(gcn_classifier_logits(params, x, a, cfg))


def count_params(params) -> int:
    return sum(int(p.size) for p in jax.tree.leaves(params))
