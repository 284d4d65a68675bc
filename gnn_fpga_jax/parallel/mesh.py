"""Device-mesh helpers for pjit/GSPMD sharding.

The reference is single-device (`/root/reference/gnn/estimator.py:30-31`
``.cuda()``); scaling here is mesh-first: a ``data`` axis for batch/data
parallelism over graphs-per-step, and a ``graph`` axis for edge-partitioning
single large (mu200-scale) graphs across chips (see
`gnn_fpga_jax/parallel/partition.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "data"
GRAPH_AXIS = "graph"


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices=None,
) -> Mesh:
    """Build a Mesh over the available devices.

    Default: all devices on one ``data`` axis.  Pass
    ``axis_sizes=(n_data, n_graph)`` with ``axis_names=("data", "graph")``
    for hybrid data x graph parallelism.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} don't cover {n} devices")
    dev_array = np.asarray(devices).reshape(axis_sizes)
    return Mesh(dev_array, axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def shard_batch_pytree(tree, mesh: Mesh, axis: str = DATA_AXIS):
    """device_put every leaf with its leading axis sharded over ``axis``."""
    sharding = batch_sharded(mesh, axis)
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)

