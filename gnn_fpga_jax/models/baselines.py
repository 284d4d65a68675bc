"""Non-GNN baseline models from the reference's exploratory notebooks.

The reference compares its message-passing models against several simpler
architectures; this module re-implements each as a pure jit-friendly
function over a parameter pytree:

- :func:`fc_segment_classifier_logits` — fully-connected segment classifier
  over the flattened node features (`MPNN_Seg_Toy2D.ipynb:cell15`
  ``FCSegmentClassifier``).
- :func:`fc_segmenter_logits` — hit-clustering FC segmenter producing a
  per-hit softmax over next-layer hits (`HitClustering_Toy2D.ipynb:cell13`
  ``build_fc_segmenter``).
- :func:`conv_segmenter_logits` — "conv-like" segmenter that stacks each
  hit with all hits on the adjacent layers, applies 1x1 feature convs, then
  same-layer convs over the track axis (`HitClustering_Toy2D.ipynb:cell24`
  ``stack_adjacent_features`` / ``build_conv_segmenter``).
- :func:`seeded_fc_logits` / :func:`seeded_cnn_logits` /
  :func:`seeded_lstm_logits` — seeded track finding as an image task over
  (layer x track-slot) hit grids: FC (`Graph_dev.ipynb:cell20`
  ``build_fnn``), CNN (`Graph_dev.ipynb:cell12` ``build_cnn``), and
  seq-to-seq LSTM (`Graph_dev.ipynb:cell28` ``build_lstm``).

All ``*_logits`` functions return pre-softmax/pre-sigmoid scores; pair with
:func:`softmax_xent` (categorical cross-entropy over the last axis, the
Keras models' loss) or sigmoid-BCE from the trainer.  Dense layers and
convs are plain matmuls / ``lax.conv`` so XLA maps them onto matmul units.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from gnn_fpga_jax.models.mpnn import _init_linear, _linear, count_params  # noqa: F401

Params = Any


def softmax_xent(logits: jax.Array, targets: jax.Array) -> jax.Array:
    """Mean categorical cross-entropy over the last axis (rows of
    ``targets`` are one-hot / row-stochastic, as in the Keras baselines)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.sum(targets * logp, axis=-1))


def row_accuracy(logits: jax.Array, targets: jax.Array) -> jax.Array:
    """Fraction of rows whose argmax matches the target's argmax."""
    return jnp.mean(
        jnp.argmax(logits, axis=-1) == jnp.argmax(targets, axis=-1))


# ---------------------------------------------------------------------------
# FCSegmentClassifier (MPNN_Seg_Toy2D.ipynb:cell15)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FCSegmentClassifierConfig:
    n_hits: int = 40
    n_segments: int = 144
    input_dim: int = 2
    hidden_dim: int = 32
    dtype: Any = jnp.float32


def init_fc_segment_classifier(key, cfg: FCSegmentClassifierConfig) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "l1": _init_linear(k1, cfg.n_hits * cfg.input_dim, cfg.hidden_dim,
                           cfg.dtype),
        "l2": _init_linear(k2, cfg.hidden_dim, cfg.n_segments, cfg.dtype),
    }


def fc_segment_classifier_logits(params, x: jax.Array,
                                 cfg: FCSegmentClassifierConfig) -> jax.Array:
    """Per-edge logits from flattened node features.

    ``x``: (..., n_hits, input_dim) node features (the graph topology is
    ignored, as in the reference's FC comparison baseline).  Returns
    (..., n_segments); apply sigmoid for edge probabilities.
    """
    flat = x.reshape(x.shape[:-2] + (cfg.n_hits * cfg.input_dim,))
    h = jax.nn.relu(_linear(params["l1"], flat))
    return _linear(params["l2"], h)


def fc_segment_classifier(params, x, cfg):
    return jax.nn.sigmoid(fc_segment_classifier_logits(params, x, cfg))


# ---------------------------------------------------------------------------
# Hit-clustering FC segmenter (HitClustering_Toy2D.ipynb:cell13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    n_layers: int = 10
    n_tracks: int = 4
    hidden_dim: int = 100
    dtype: Any = jnp.float32


def init_fc_segmenter(key, cfg: SegmenterConfig) -> Params:
    k1, k2, k3 = jax.random.split(key, 3)
    nl, nt = cfg.n_layers, cfg.n_tracks
    return {
        "l1": _init_linear(k1, nl * nt, cfg.hidden_dim, cfg.dtype),
        "l2": _init_linear(k2, cfg.hidden_dim, cfg.hidden_dim, cfg.dtype),
        "out": _init_linear(k3, cfg.hidden_dim, (nl - 1) * nt * nt, cfg.dtype),
    }


def fc_segmenter_logits(params, grids: jax.Array,
                        cfg: SegmenterConfig) -> jax.Array:
    """``grids``: (B, n_layers, n_tracks) sorted hit positions.  Returns
    (B, (n_layers-1)*n_tracks, n_tracks) logits — row r = softmax scores of
    hit r's continuation over the next layer's slots."""
    b = grids.shape[0]
    h = grids.reshape(b, -1)
    h = jax.nn.relu(_linear(params["l1"], h))
    h = jax.nn.relu(_linear(params["l2"], h))
    out = _linear(params["out"], h)
    return out.reshape(b, (cfg.n_layers - 1) * cfg.n_tracks, cfg.n_tracks)


def fc_segmenter(params, grids, cfg):
    return jax.nn.softmax(fc_segmenter_logits(params, grids, cfg), axis=-1)


# ---------------------------------------------------------------------------
# Conv-like segmenter (HitClustering_Toy2D.ipynb:cell24)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSegmenterConfig:
    n_layers: int = 10
    n_tracks: int = 4
    adj_filters: Sequence[int] = (32, 32, 32, 32)
    lay_filters: Sequence[int] = (16, 16)
    dtype: Any = jnp.float32


def stack_adjacent_features(x: jax.Array) -> jax.Array:
    """Stack each hit's features with ALL hits on the previous and next
    detector layers (`HitClustering_Toy2D.ipynb:cell24`).

    ``x``: (B, L, T, F) -> (B, L, T, F + 2*T*F); the adjacent-layer blocks
    are zero on the boundary layers (the reference's zero spatial padding).
    """
    b, nl, nt, f = x.shape
    flat = x.reshape(b, nl, nt * f)
    rep = jnp.broadcast_to(flat[:, :, None, :], (b, nl, nt, nt * f))
    pad = jnp.zeros((b, 1, nt, nt * f), x.dtype)
    padded = jnp.concatenate([pad, rep, pad], axis=1)
    bwd, fwd = padded[:, :-2], padded[:, 2:]
    return jnp.concatenate([bwd, x, fwd], axis=-1)


def _conv_track_axis(x, w, b):
    """'Same'-padded conv over the track axis (kernel size = n_tracks),
    NHWC with H = detector layer, W = track slot."""
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return out + b


def init_conv_segmenter(key, cfg: ConvSegmenterConfig) -> Params:
    nt = cfg.n_tracks
    keys = jax.random.split(key, len(cfg.adj_filters) + len(cfg.lay_filters) + 1)
    params = {"adj": [], "lay": []}
    f = 1
    for i, nf in enumerate(cfg.adj_filters):
        # 1x1 conv over stacked adjacent features == dense over features
        params["adj"].append(_init_linear(keys[i], f + 2 * nt * f, nf, cfg.dtype))
        f = nf
    f = f + 1  # input shortcut concat
    k = len(cfg.adj_filters)
    for j, nf in enumerate(cfg.lay_filters):
        kw, kb = jax.random.split(keys[k + j])
        bound = 1.0 / jnp.sqrt(jnp.asarray(nt * f, jnp.float32))
        params["lay"].append({
            "w": jax.random.uniform(kw, (1, nt, f, nf), cfg.dtype, -bound, bound),
            "b": jax.random.uniform(kb, (nf,), cfg.dtype, -bound, bound),
        })
        f = nf
    kw, kb = jax.random.split(keys[-1])
    bound = 1.0 / jnp.sqrt(jnp.asarray(nt * f, jnp.float32))
    params["out"] = {
        "w": jax.random.uniform(kw, (1, nt, f, nt), cfg.dtype, -bound, bound),
        "b": jax.random.uniform(kb, (nt,), cfg.dtype, -bound, bound),
    }
    return params


def conv_segmenter_logits(params, grids: jax.Array,
                          cfg: ConvSegmenterConfig) -> jax.Array:
    """``grids``: (B, L, T) -> (B, (L-1)*T, T) next-layer association logits.

    Adjacent-layer feature stacking + 1x1 convs, input shortcut concat,
    slice off the last layer (no outgoing segments), same-layer convs over
    the track axis, final linear conv to T channels
    (`HitClustering_Toy2D.ipynb:cell24` ``build_conv_segmenter``).
    """
    b = grids.shape[0]
    x = grids[..., None]                                  # (B, L, T, 1)
    h = x
    for p in params["adj"]:
        h = jax.nn.relu(_linear(p, stack_adjacent_features(h)))
    h = jnp.concatenate([h, x], axis=-1)[:, :-1]          # (B, L-1, T, F+1)
    for p in params["lay"]:
        h = jax.nn.relu(_conv_track_axis(h, p["w"], p["b"]))
    out = _conv_track_axis(h, params["out"]["w"], params["out"]["b"])
    return out.reshape(b, (cfg.n_layers - 1) * cfg.n_tracks, cfg.n_tracks)


def conv_segmenter(params, grids, cfg):
    return jax.nn.softmax(conv_segmenter_logits(params, grids, cfg), axis=-1)


# ---------------------------------------------------------------------------
# Seeded track finding on hit grids (Graph_dev.ipynb)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeededConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    hidden_dim: int = 100
    dtype: Any = jnp.float32


def init_seeded_fc(key, cfg: SeededConfig) -> Params:
    """3 ReLU hidden layers over [flat grid, flat seed]
    (`Graph_dev.ipynb:cell20` ``build_fnn``)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    nl, nt, h = cfg.n_layers, cfg.n_tracks, cfg.hidden_dim
    return {
        "l1": _init_linear(k1, nl * nt + cfg.seed_size * nt, h, cfg.dtype),
        "l2": _init_linear(k2, h, h, cfg.dtype),
        "l3": _init_linear(k3, h, h, cfg.dtype),
        "out": _init_linear(k4, h, nl * nt, cfg.dtype),
    }


def seeded_fc_logits(params, grids, seeds, cfg: SeededConfig) -> jax.Array:
    """(grids (B,L,T), seeds (B,seed,T)) -> per-layer slot logits (B,L,T);
    softmax over the track-slot axis selects the seeded track's hit."""
    b = grids.shape[0]
    h = jnp.concatenate([grids.reshape(b, -1), seeds.reshape(b, -1)], axis=-1)
    h = jax.nn.relu(_linear(params["l1"], h))
    h = jax.nn.relu(_linear(params["l2"], h))
    h = jax.nn.relu(_linear(params["l3"], h))
    return _linear(params["out"], h).reshape(b, cfg.n_layers, cfg.n_tracks)


def seeded_fc(params, grids, seeds, cfg):
    return jax.nn.softmax(seeded_fc_logits(params, grids, seeds, cfg), axis=-1)


@dataclasses.dataclass(frozen=True)
class SeededCNNConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    n_conv: int = 8
    n_filters: int = 8
    kernel: int = 5
    dtype: Any = jnp.float32


def _seed_channel(seeds, n_layers):
    """Zero-pad the seed one-hots to a full (B, L, T) channel
    (`Graph_dev.ipynb:cell9` fills ``model_input[ievt, 1, :seed_size]``)."""
    b, s, nt = seeds.shape
    return jnp.concatenate(
        [seeds, jnp.zeros((b, n_layers - s, nt), seeds.dtype)], axis=1)


def init_seeded_cnn(key, cfg: SeededCNNConfig) -> Params:
    keys = jax.random.split(key, cfg.n_conv)
    params = []
    f = 2
    k = cfg.kernel
    for i in range(cfg.n_conv):
        nf = cfg.n_filters if i < cfg.n_conv - 1 else 1
        kw, kb = jax.random.split(keys[i])
        bound = 1.0 / jnp.sqrt(jnp.asarray(k * k * f, jnp.float32))
        params.append({
            "w": jax.random.uniform(kw, (k, k, f, nf), cfg.dtype, -bound, bound),
            "b": jax.random.uniform(kb, (nf,), cfg.dtype, -bound, bound),
        })
        f = nf
    return {"conv": params}


def seeded_cnn_logits(params, grids, seeds, cfg: SeededCNNConfig) -> jax.Array:
    """Stacked 5x5 'same' convs over the 2-channel (hit grid, seed map)
    image, final 1-channel conv -> per-layer slot logits (B, L, T)
    (`Graph_dev.ipynb:cell12` ``build_cnn``)."""
    x = jnp.stack([grids, _seed_channel(seeds, cfg.n_layers)], axis=-1)
    h = x
    for i, p in enumerate(params["conv"]):
        h = jax.lax.conv_general_dilated(
            h, p["w"], window_strides=(1, 1), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["b"]
        if i < len(params["conv"]) - 1:
            h = jax.nn.relu(h)
    return h[..., 0]


def seeded_cnn(params, grids, seeds, cfg):
    return jax.nn.softmax(seeded_cnn_logits(params, grids, seeds, cfg), axis=-1)


@dataclasses.dataclass(frozen=True)
class SeededLSTMConfig:
    n_layers: int = 10
    n_tracks: int = 10
    seed_size: int = 3
    hidden_dim: int = 10
    dtype: Any = jnp.float32


def init_seeded_lstm(key, cfg: SeededLSTMConfig) -> Params:
    """LSTM over the detector-layer sequence + per-layer dense softmax head
    (`Graph_dev.ipynb:cell28` ``build_lstm``)."""
    kx, kh, kb, ko = jax.random.split(key, 4)
    in_dim, h = 2 * cfg.n_tracks, cfg.hidden_dim
    bound = 1.0 / jnp.sqrt(jnp.asarray(h, jnp.float32))
    return {
        "wx": jax.random.uniform(kx, (in_dim, 4 * h), cfg.dtype, -bound, bound),
        "wh": jax.random.uniform(kh, (h, 4 * h), cfg.dtype, -bound, bound),
        "b": jnp.zeros((4 * h,), cfg.dtype)
             .at[h:2 * h].set(1.0),  # forget-gate bias 1 (Keras default)
        "out": _init_linear(ko, h, cfg.n_tracks, cfg.dtype),
    }


def seeded_lstm_logits(params, grids, seeds, cfg: SeededLSTMConfig) -> jax.Array:
    """Sequence-to-sequence track following: layer-by-layer LSTM over
    [hit positions, seed channel], dense slot logits per layer (B, L, T)."""
    seq = jnp.concatenate(
        [grids, _seed_channel(seeds, cfg.n_layers)], axis=-1)  # (B, L, 2T)
    h_dim = cfg.hidden_dim
    b = seq.shape[0]

    def cell(carry, x_t):
        h, c = carry
        z = x_t @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = jnp.split(z, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), h

    init = (jnp.zeros((b, h_dim), seq.dtype), jnp.zeros((b, h_dim), seq.dtype))
    _, hs = jax.lax.scan(cell, init, seq.transpose(1, 0, 2))
    return _linear(params["out"], hs.transpose(1, 0, 2))


def seeded_lstm(params, grids, seeds, cfg):
    return jax.nn.softmax(seeded_lstm_logits(params, grids, seeds, cfg), axis=-1)
