"""The port's multi-process helpers (``platanus3_tpu_torch/parallel/
multihost.py``) against the JAX package's.

``host_local_batch`` is held to JAX's for 1 to 4 hosts, array for array.
``initialize`` with explicit coordinator arguments brings up two CPU
processes (``torch_mesh_worker.launch``, a 300 s timeout), each of which
runs ``gather_to_host0`` and ``host_local_batch`` with the process
group's own rank and size.
"""

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.parallel import multihost as JM
from platanus3_tpu_torch.io import reads as treads
from platanus3_tpu_torch.parallel import multihost as TM

FIELDS = ("packed", "valid_len", "read_id", "start", "read_len",
          "prev_base", "next_base")


def _batches():
    reads = worker.stage1_reads()
    return (jreads.reads_from_strings(reads, 25, 256),
            treads.reads_from_strings(reads, 25, 256))


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_host_local_batch_matches_jax(hosts):
    jb, tb = _batches()
    rows = 0
    for h in range(hosts):
        j = JM.host_local_batch(jb, n_hosts=hosts, host_id=h)
        t = TM.host_local_batch(tb, n_hosts=hosts, host_id=h)
        for f in FIELDS:
            a, b = getattr(j, f), getattr(t, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (t.num_reads, t.all_bases, t.chunk_len) == \
            (tb.num_reads, tb.all_bases, tb.chunk_len)
        rows += t.packed.shape[0]
    assert rows == tb.num_chunks


def test_single_process_helpers_are_the_identity():
    tree = {"a": np.arange(3), "b": [torch.ones(2)]}
    assert TM.gather_to_host0(tree) is tree
    TM.initialize()            # no launcher's environment: nothing to join
    assert not torch.distributed.is_initialized()
    _, tb = _batches()
    assert TM.host_local_batch(tb).packed.shape == tb.packed.shape


def test_initialize_two_processes_and_gather(tmp_path):
    """``initialize(coordinator_address, num_processes, process_id)`` in two
    processes, then ``gather_to_host0`` (every rank's arrays stacked
    rank-major, as JAX's ``process_allgather``) and ``host_local_batch``
    with the group's rank and size."""
    got = worker.launch(tmp_path, ["init_explicit"], nproc=2)["init_explicit"]
    jb, _ = _batches()
    for r, out in enumerate(got):
        assert (out["rank"], out["size"], out["backend"]) == (r, 2, "gloo")
        assert out["devices"] == ["cpu", "cpu"]
        assert np.array_equal(out["np"], np.repeat(np.arange(2, dtype=np.int32)
                                                   [:, None], 3, axis=1))
        assert np.array_equal(out["t"], np.arange(2)[:, None, None]
                              * np.ones((2, 2, 2), np.int64))
        want = JM.host_local_batch(jb, n_hosts=2, host_id=r)
        assert np.array_equal(out["packed"], want.packed)
        assert np.array_equal(out["read_id"], want.read_id)
