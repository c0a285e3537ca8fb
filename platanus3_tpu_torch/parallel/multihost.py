"""Multi-process execution support.

Port of ``platanus3_tpu/parallel/multihost.py`` onto
``torch.distributed``.  Each rank is one process with one device; a
launcher starts them (``python -m torch.distributed.run --nproc-per-node
N ...``, the ``env://`` contract), or each process names the coordinator
itself (``initialize``, JAX's signature, mapped onto
``init_process_group(init_method="tcp://...")``):

* :func:`initialize` -- join the process group (idempotent; a no-op for a
  single process without a launcher's environment);
* :func:`global_mesh` -- this rank's ``sharded.Mesh`` over all ranks;
* :func:`host_local_batch` -- slice a loaded ``ReadBatch`` to this rank's
  contiguous chunk range (chunk rows are self-contained, so any partition
  is valid; every process may load the whole file and keep its range);
* :func:`gather_to_host0` -- every rank's arrays, stacked rank-major, for
  the final stitch on rank 0.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from platanus3_tpu_torch.parallel import sharded

__all__ = ["initialize", "global_mesh", "host_local_batch",
           "gather_to_host0"]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device="cuda", local_rank=None):
    """Join the process group of ``num_processes`` ranks through the
    coordinator at ``coordinator_address`` ("host:port"); with no
    arguments, through a launcher's environment if there is one.  On a
    host whose process sees several cards, ``local_rank`` (else
    LOCAL_RANK) picks this rank's card; the backend follows from the
    ranks' cards (``sharded.init_ranks``).  ``global_mesh`` takes the
    same ``device``."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world > 1:
            sharded.init_ranks(device, world_size=world,
                               rank=int(os.environ.get("RANK", 0)),
                               local_rank=local_rank)
        return
    sharded.init_ranks(device, world_size=num_processes, rank=process_id,
                       init_method=f"tcp://{coordinator_address}",
                       local_rank=local_rank)


def global_mesh(device="cuda") -> sharded.Mesh:
    """This rank's mesh over every rank of the process group."""
    return sharded.make_mesh(device)


def host_local_batch(batch, n_hosts=None, host_id=None):
    """Slice a ReadBatch's chunk arrays to this rank's contiguous range
    (``ceil(C / n)`` chunks a rank)."""
    initialized = dist.is_initialized()
    n = n_hosts if n_hosts is not None else (
        dist.get_world_size() if initialized else 1)
    h = host_id if host_id is not None else (
        dist.get_rank() if initialized else 0)
    c = batch.packed.shape[0]
    per = -(-c // n)
    lo, hi = h * per, min((h + 1) * per, c)
    return dataclasses.replace(batch, **{
        f: getattr(batch, f)[lo:hi] for f in (
            "packed", "valid_len", "read_id", "start", "read_len",
            "prev_base", "next_base")})


def gather_to_host0(tree):
    """Every rank's arrays (a numpy array or tensor, or a dict, list or
    tuple of them), each stacked on a new leading rank axis (JAX's
    ``process_allgather``; shapes must agree across ranks); a single
    process gets ``tree`` back."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    if isinstance(tree, dict):
        return {key: gather_to_host0(v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host0(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, tree.cpu())
        return torch.stack(parts).to(tree.device)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(tree))
    return np.stack(parts)
