"""Checkpoint / resume with best-model retention.

Mirrors the reference Estimator's checkpoint subsystem
(`/root/reference/gnn/estimator.py:62-78,124-135`): every epoch saves
``{epoch, params, opt_state, best_valid_loss, train_losses, valid_losses}``
and copies to ``model_best`` when validation improves; loading restores the
optimizer state and loss histories so ``fit`` resumes epoch numbering from
``len(train_losses)`` (`estimator.py:84-85`).

Array pytrees (params, optimizer state) go to one NPZ written by
:func:`~gnn_fpga_jax.utils.serialization.save_params_npz`; scalar metadata
and loss histories go to a JSON sidecar — histories grow every epoch, so
they are not part of the fixed-shape array state.  Each checkpoint is a
directory written under a temporary name and renamed into place, so a
crash mid-save leaves the previous one intact.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

from gnn_fpga_jax.utils.serialization import load_npz_like, save_params_npz

_LATEST = "checkpoint"
_BEST = "model_best"
_ARRAYS = "state.npz"
_META = "meta.json"


class CheckpointManager:
    """Save/restore train state under a directory, keeping latest + best."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, arrays: Dict[str, Any], meta: Dict[str, Any],
             is_best: bool = False) -> None:
        """``arrays``: pytrees of fixed-shape arrays (params, opt_state).
        ``meta``: JSON-serialisable scalars/lists (epoch, histories)."""
        self._save_one(arrays, meta, _LATEST)
        if is_best:
            self._save_one(arrays, meta, _BEST)

    def _save_one(self, arrays, meta, name):
        path = self._path(name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_params_npz(os.path.join(tmp, _ARRAYS), arrays)
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def restore(self, template: Dict[str, Any], best: bool = False
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """(arrays, meta) restored into ``template``'s structure; None if
        absent."""
        path = self._path(_BEST if best else _LATEST)
        if not os.path.exists(path):
            return None
        arrays = load_npz_like(os.path.join(path, _ARRAYS), template)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        return arrays, meta

    def exists(self, best: bool = False) -> bool:
        return os.path.exists(self._path(_BEST if best else _LATEST))
