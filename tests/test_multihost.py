"""Multi-host helpers (parallel/multihost.py) — single-process semantics on
the 8-device CPU mesh."""

import jax
import numpy as np

from gnn_fpga_jax.parallel import mesh as mesh_lib
from gnn_fpga_jax.parallel import multihost as mh


def test_initialize_single_process_noop():
    mh.initialize()  # must not raise without a coordinator
    info = mh.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] == len(jax.devices())


def test_local_shard_strided_disjoint_and_equal_length():
    items = list(range(10))
    shards = [mh.local_shard(items, process_id=p, process_count=3)
              for p in range(3)]
    # Equal shard lengths (SPMD invariant): trailing remainder is dropped
    # on every host, so per-host batch counts always agree.
    assert [len(s) for s in shards] == [3, 3, 3]
    flat = sum(shards, [])
    assert len(set(flat)) == len(flat)  # disjoint
    assert shards[0] == [0, 3, 6]


def test_host_slice_partitions_batch():
    slices = [mh.host_slice(32, process_id=p, process_count=4)
              for p in range(4)]
    covered = np.concatenate([np.arange(32)[s] for s in slices])
    np.testing.assert_array_equal(np.sort(covered), np.arange(32))


def test_global_batch_to_device_shards_leading_axis():
    mesh = mesh_lib.make_mesh()
    n = len(jax.devices())
    local = {"x": np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3)}
    out = mh.global_batch_to_device(local, mesh)
    assert out["x"].shape == (n * 4, 3)
    np.testing.assert_array_equal(np.asarray(out["x"]), local["x"])
    # leading axis really is sharded over the data axis
    assert len(out["x"].sharding.device_set) == n
