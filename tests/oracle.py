"""NumPy dense-incidence-matrix oracle of the reference forward pass.

Independent re-implementation (in numpy, from the math) of the reference
models' forward semantics (`/root/reference/gnn/model.py:36-156`,
`MPNN_HitClassifier.ipynb:cell21`, `GCN_Toy2D.ipynb:cell11-14`), used as
the activation-parity test oracle: the dense ``bmm`` formulation over
incidence matrices Ri/Ro must match the COO gather/segment-sum model
per-iteration to float tolerance.

The segment-classifier functions take an array module ``xp`` (default
NumPy): with ``xp=jax.numpy`` under ``jax.enable_x64`` the same float64
formulas are differentiable, which gives a parameter-gradient oracle.
"""

import numpy as np


def _linear(p, x, mask=None, xp=np):
    w = p["w"] if mask is None else p["w"] * xp.asarray(mask)
    return x @ xp.asarray(w) + xp.asarray(p["b"])


def _np_params(params):
    import jax
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float64), params)


def sigmoid(z, xp=np):
    return 1.0 / (1.0 + xp.exp(-z))


def edge_network_dense(p, x, ri, ro, masks=None, xp=np):
    """e = sigmoid(MLP([Ro^T X, Ri^T X])) — dense form of model.py:69-81."""
    bo = ro.T @ x
    bi = ri.T @ x
    b = xp.concatenate([bo, bi], axis=-1)
    m1 = None if masks is None else masks.get("l1")
    m2 = None if masks is None else masks.get("l2")
    z = xp.tanh(_linear(p["l1"], b, m1, xp))
    return sigmoid(_linear(p["l2"], z, m2, xp), xp)[..., 0]


def node_network_dense(p, x, e, ri, ro, masks=None, xp=np):
    """M = [Ri·e·(Ro^T X), Ro·e·(Ri^T X), X] -> tanh MLP — model.py:113-125."""
    bo = ro.T @ x
    bi = ri.T @ x
    rwi = ri * e[None, :]
    rwo = ro * e[None, :]
    mi = rwi @ bo
    mo = rwo @ bi
    m = xp.concatenate([mi, mo, x], axis=-1)
    m1 = None if masks is None else masks.get("l1")
    m2 = None if masks is None else masks.get("l2")
    z = xp.tanh(_linear(p["l1"], m, m1, xp))
    return xp.tanh(_linear(p["l2"], z, m2, xp))


def segment_classifier_dense(params, x, ri, ro, n_iters, masks=None,
                             return_intermediates=False, xp=np):
    """Dense forward of SegmentClassifier (model.py:140-156)."""
    if xp is np:
        params = _np_params(params)
        x = np.asarray(x, np.float64)
    masks_e = None if masks is None else masks.get("edge")
    masks_n = None if masks is None else masks.get("node")
    h = xp.tanh(_linear(params["input"], x, xp=xp))
    h = xp.concatenate([h, x], axis=-1)
    es, hs = [], [h]
    for _ in range(n_iters):
        e = edge_network_dense(params["edge"], h, ri, ro, masks_e, xp)
        h = node_network_dense(params["node"], h, e, ri, ro, masks_n, xp)
        h = xp.concatenate([h, x], axis=-1)
        es.append(e)
        hs.append(h)
    out = edge_network_dense(params["edge"], h, ri, ro, masks_e, xp)
    if return_intermediates:
        return out, es, hs
    return out


def node_classifier_dense(params, x, ri, ro, n_iters):
    """Dense forward of NodeClassifier (MPNN_HitClassifier.ipynb:cell21)."""
    params = _np_params(params)
    x = np.asarray(x, np.float64)
    h = np.tanh(_linear(params["input"], x))
    h = np.concatenate([h, x], axis=-1)
    for _ in range(n_iters):
        e = edge_network_dense(params["edge"], h, ri, ro)
        h = node_network_dense(params["node"], h, e, ri, ro)
        h = np.concatenate([h, x], axis=-1)
    return sigmoid(_linear(params["output"], h))[..., 0]


def segment_classifier_unshared_dense(params, x, ri, ro, n_iters):
    """Dense forward of the per-iteration-weights variant
    (MPNN_Seg_Toy2D.ipynb:cell14)."""
    import jax
    params = _np_params(params)
    x = np.asarray(x, np.float64)
    h = np.tanh(_linear(params["input"], x))
    h = np.concatenate([h, x], axis=-1)
    for i in range(n_iters):
        ep = jax.tree.map(lambda a: a[i], params["edge_stack"])
        npp = jax.tree.map(lambda a: a[i], params["node_stack"])
        e = edge_network_dense(ep, h, ri, ro)
        h = node_network_dense(npp, h, e, ri, ro)
        h = np.concatenate([h, x], axis=-1)
    return edge_network_dense(params["output"], h, ri, ro)


def segment_classifier_bce_grads(params, x, ri, ro, y, mask, n_iters):
    """Parameter gradients of the masked mean BCE of
    :func:`segment_classifier_dense` over a batch (leading graph axis on
    ``x, ri, ro, y, mask``), in float64 on the host CPU."""
    import jax
    import jax.numpy as jnp

    def loss(p, x, ri, ro, y, m):
        prob = jax.vmap(lambda xb, rib, rob: segment_classifier_dense(
            p, xb, rib, rob, n_iters, xp=jnp))(x, ri, ro)
        per = -(y * jnp.log(prob) + (1.0 - y) * jnp.log1p(-prob))
        return (per * m).sum() / m.sum()

    arrays = [np.asarray(a, np.float64) for a in (x, ri, ro, y, mask)]
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        grads = jax.jit(jax.grad(loss))(_np_params(params), *arrays)
        return jax.tree.map(np.asarray, grads)
