"""Robust NPZ (de)serialisation of parameter pytrees.

The reference saves a bare torch ``state_dict``
(`/root/reference/gnn/trainSegmentClassifier.py:192-201`); here params are
arbitrary JAX pytrees (nested dicts, stacked per-iteration lists, masks).
Leaves are stored as ``leaf_<i>`` arrays plus one JSON-encoded key-path
table, so any dict/list/tuple nesting and any key string (including
``[``/quotes) round-trips exactly — unlike keystr-based flattening.
"""

from __future__ import annotations

import json

import jax
import numpy as np

_PATHS_KEY = "__tree_paths__"


def _encode_entry(entry) -> list:
    if isinstance(entry, jax.tree_util.DictKey):
        return ["d", entry.key]
    if isinstance(entry, jax.tree_util.SequenceKey):
        return ["s", entry.idx]
    if isinstance(entry, jax.tree_util.GetAttrKey):
        return ["a", entry.name]
    if isinstance(entry, jax.tree_util.FlattenedIndexKey):
        return ["f", entry.key]
    raise TypeError(f"unsupported key path entry {entry!r}")


def save_params_npz(path, params) -> None:
    """Write a params pytree to NPZ: ``leaf_<i>`` arrays + a path table."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, (_, leaf) in enumerate(flat)}
    spec = [[_encode_entry(e) for e in kp] for kp, _ in flat]
    encoded = np.frombuffer(json.dumps(spec).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays, **{_PATHS_KEY: encoded})


def _insert(root, path, value):
    """Insert ``value`` into the nested dict/list structure at ``path``."""
    node = root
    for i, (kind, key) in enumerate(path):
        last = i == len(path) - 1
        if kind == "d" or kind == "a" or kind == "f":
            if last:
                node[key] = value
            else:
                node = node.setdefault(key, {})
        elif kind == "s":
            # represent sequences as dicts keyed by int; fixed up afterwards
            if last:
                node[("seq", key)] = value
            else:
                node = node.setdefault(("seq", key), {})
        else:
            raise ValueError(f"unknown path entry kind {kind!r}")
    return root


def _fix_sequences(node):
    """Convert {('seq', i): v} dicts back into lists, recursively."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(isinstance(k, tuple) and k and k[0] == "seq" for k in keys):
        items = sorted(node.items(), key=lambda kv: kv[0][1])
        return [_fix_sequences(v) for _, v in items]
    return {k: _fix_sequences(v) for k, v in node.items()}


def load_params_npz(path):
    """Inverse of :func:`save_params_npz`.

    Falls back to parsing keystr-style flat keys (the round-1 train-CLI
    format) when the path table is absent, so old artifacts still load.
    """
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    if _PATHS_KEY not in data:
        return _load_keystr_format(data)
    spec = json.loads(bytes(data[_PATHS_KEY].tobytes()).decode("utf-8"))
    root: dict = {}
    for i, path_entries in enumerate(spec):
        _insert(root, [(e[0], e[1]) for e in path_entries], data[f"leaf_{i}"])
    return _fix_sequences(root)


def load_npz_like(path, template):
    """Load an NPZ written by :func:`save_params_npz` into ``template``'s
    tree structure (optax states, tuples and all), checking that the
    stored key paths and leaf shapes are the template's."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    want = json.loads(json.dumps(
        [[_encode_entry(e) for e in kp] for kp, _ in flat]))
    got = json.loads(bytes(data[_PATHS_KEY].tobytes()).decode("utf-8"))
    if got != want:
        raise ValueError(f"{path}: stored tree does not match the template")
    leaves = [data[f"leaf_{i}"] for i in range(len(flat))]
    for (kp, ref), leaf in zip(flat, leaves):
        if np.shape(ref) != leaf.shape:
            raise ValueError(
                f"{path}: {jax.tree_util.keystr(kp)} has shape {leaf.shape}, "
                f"template has {np.shape(ref)}")
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _load_keystr_format(flat: dict):
    """Legacy loader for ``jax.tree_util.keystr`` flat keys like
    ``['edge']['l1']['w']`` (plain dict layouts only)."""
    params: dict = {}
    for keystr, arr in flat.items():
        keys = [k.strip("'\"") for k in keystr.replace("]", "").split("[") if k]
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return params
