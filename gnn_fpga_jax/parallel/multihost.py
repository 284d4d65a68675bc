"""Multi-host (multi-process) initialisation and per-host data sharding.

The reference has no distributed backend at all (SURVEY.md §2.3 — its only
parallelism is a preprocessing ``mp.Pool``, `prepareGraphs.py:196-207`);
this module provides the multi-process entry points the rebuild adds on top:

- :func:`initialize` — `jax.distributed.initialize` wrapper, safe to call
  in single-process runs (no-op) and idempotent.
- :func:`local_shard` / :func:`host_slice` — split a global list/array of
  graphs so each host process loads and feeds only its own shard (the
  replacement for the reference's single-process file loop,
  `trainSegmentClassifier.py:128-131`).
- :func:`global_batch_to_device` — form a jax.Array for a globally-sharded
  batch from per-host local data (`jax.make_array_from_process_local_data`).

Collectives between devices are handled by XLA/GSPMD once arrays carry
NamedShardings — nothing NCCL/MPI-like to manage here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialise multi-process JAX (idempotent; no-op if single-process).

    With no arguments, relies on a cluster environment JAX can detect
    (e.g. Slurm); elsewhere pass the coordinator address, process count
    and process id explicitly.

    MUST be called before anything that initialises the XLA backend
    (`jax.devices()`, `jax.process_count()`, any computation) — so this
    function deliberately touches neither.  Idempotency is checked via the
    module flag and the distributed client handle; the "no cluster
    detected" case (plain single-process run) is the ``ValueError`` that
    `jax.distributed.initialize` raises when it cannot find a coordinator,
    which we treat as a no-op.
    """
    global _initialized
    if _initialized:
        return
    try:
        from jax._src import distributed as _dist
        if _dist.global_state.client is not None:  # already initialised
            _initialized = True
            return
    except (ImportError, AttributeError):
        pass
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except ValueError:
        # No coordinator address given or auto-detectable: single-process.
        pass
    except RuntimeError as e:
        msg = str(e)
        if "once" in msg:
            pass  # initialised elsewhere — fine
        elif ("before" in msg and coordinator_address is None
              and num_processes is None):
            # The XLA backend is already up and no cluster was requested:
            # a single-process run that computed before calling us. No-op.
            pass
        else:
            # Explicit multi-host request after backend init is a real
            # ordering bug — surface it.
            raise
    _initialized = True


def process_info() -> dict:
    """{'process_id', 'process_count', 'local_devices', 'global_devices'}."""
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def local_shard(items: Sequence, process_id: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """This host's strided shard of a global work list (e.g. graph NPZ
    filenames) — every process loads disjoint data.

    All hosts return shards of the SAME length (``len(items) // n``):
    in SPMD training unequal per-host batch counts deadlock collectives,
    so the trailing ``len(items) % n`` items are dropped everywhere.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    per = len(items) // n
    return list(items[pid::n][:per])


def host_slice(n_global: int, process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """Contiguous [start, stop) range of a global batch owned by this host
    (global batch axis split evenly across processes)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by {n} hosts")
    per = n_global // n
    return slice(pid * per, (pid + 1) * per)


def global_batch_to_device(local_tree, mesh: Mesh, axis: str = "data"):
    """Assemble a globally-sharded batch from per-host local arrays.

    Each process passes its local slice (leading axis = local batch); the
    result is a pytree of jax.Arrays whose global leading axis is sharded
    over ``axis`` across all processes' devices.
    """
    sharding = NamedSharding(mesh, P(axis))

    def make(a):
        a = np.asarray(a)
        return jax.make_array_from_process_local_data(sharding, a)

    return jax.tree.map(make, local_tree)
