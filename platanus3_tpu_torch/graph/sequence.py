"""Per-state sequence character contributions.

Port of ``platanus3_tpu/graph/sequence.py``: every kept chain member
state contributes the LAST base of its k-mer in the traversal
orientation (the head contributes its whole k-mer, graph/emit.py).
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch.graph.build import DBG
from platanus3_tpu_torch.ops import kmer as kmer_mod

__all__ = ["member_chars"]


def member_chars(dbg: DBG, k: int) -> torch.Tensor:
    """[2M] char code contributed by each node state ``s = 2*node + o``:
    o=0 the last base of the canonical k-mer, o=1 the complement of its
    first base."""
    lastb = kmer_mod.last_base(dbg.nodes, k)
    firstb = kmer_mod.first_base(dbg.nodes, k)
    return torch.stack([lastb, 3 - firstb], dim=1).reshape(-1)
