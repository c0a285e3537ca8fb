"""Turn the JAX package's state, given as numpy arrays, into the port's.

The assembler has no weights: its state is the read batch, the node
table, the Bloom words and the graph (``DBG``).  These converters take
any object with the JAX structure's field names whose leaves convert
with ``np.asarray`` (a JAX ``KmerTable``, a dict-like namespace of numpy
arrays, ...), so a test can feed one stage's output of the JAX package
into the next stage of the port.  Lanes become int64 tensors holding the
uint32 values; Bloom words become the int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from platanus3_tpu_torch.graph.build import DBG
from platanus3_tpu_torch.io.reads import ReadBatch
from platanus3_tpu_torch.ops.bloom import BloomFilter
from platanus3_tpu_torch.ops.count import KmerTable
from platanus3_tpu_torch.ops.count_oa import OAHashTable

__all__ = ["tensor_from_numpy", "from_numpy_read_batch", "from_numpy_table",
           "from_numpy_bloom", "from_numpy_oa_table", "from_numpy_dbg"]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """Integer arrays -> int64, bool -> bool, on ``device``."""
    a = np.asarray(a)
    a = a.copy() if a.dtype == np.bool_ else a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def from_numpy_read_batch(batch) -> ReadBatch:
    """A JAX ``ReadBatch`` (numpy fields) -> the port's ``ReadBatch``."""
    return ReadBatch(**{f: getattr(batch, f)
                        for f in ReadBatch.__dataclass_fields__})


def from_numpy_table(table, device="cpu") -> KmerTable:
    return KmerTable(*[tensor_from_numpy(getattr(table, f), device)
                       for f in KmerTable._fields])


def from_numpy_bloom(bits, log2_bits: int, num_hashes: int,
                     device="cpu") -> BloomFilter:
    """uint32 filter words -> a ``BloomFilter`` of int32 bit patterns."""
    words = np.asarray(bits).astype(np.uint32)
    return BloomFilter(torch.from_numpy(words.view(np.int32)).to(device),
                       log2_bits, num_hashes)


def from_numpy_oa_table(table, device="cpu") -> OAHashTable:
    """A JAX ``OAHashTable`` -> the port's: int64 lanes, int32 counts and
    a 0-dim int64 overflow.  Blocked Bloom words convert with
    ``from_numpy_bloom``."""
    return OAHashTable(
        keys=tensor_from_numpy(table.keys, device),
        counts=torch.from_numpy(np.asarray(table.counts).astype(np.int32))
        .to(device),
        overflow=tensor_from_numpy(table.overflow, device))


def from_numpy_dbg(dbg, device="cpu") -> DBG:
    return DBG(*[tensor_from_numpy(getattr(dbg, f), device)
                 for f in DBG._fields])
