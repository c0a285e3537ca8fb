"""Multi-k iterative assembly (BASELINE config 4).

Port of ``platanus3_tpu/graph/multik.py``: assemble at increasing k (e.g.
32 -> 64 -> 128), re-seeding each round's graph with the previous round's
unitigs through the ``extra_solid`` hook of ``pipeline.assemble`` (or of
``streaming.assemble_streaming`` with ``streaming=True``).  Their k-mers
join the next round's node table and their first k-mers its seeds,
bypassing the solidity filter without touching the read batch, so
coverage stays read-derived.

Each round chunks the reads for its own k.  A file source is loaded
again for every round through the native loader (one pass of C++ over
the file), rather than re-chunking parsed strings in Python; the batch is
the same, and so is the GFA.
"""

from __future__ import annotations

import dataclasses

from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.pipeline import (AssemblyResult, assemble,
                                          check_device)

__all__ = ["assemble_multik"]


def assemble_multik(source, config: AssemblyConfig, log=None, mesh=None,
                    write_output: bool = True, streaming: bool = False,
                    slice_chunks: int = 2048,
                    device="cuda") -> AssemblyResult:
    """Iterate assembly over ``config.k_list`` on ``device``, re-seeding
    each round with the previous round's unitigs via ``extra_solid``;
    returns the last round's result.  ``streaming=True`` runs every round
    through the streaming pipeline with ``slice_chunks`` chunks a slice.
    ``source`` is a read file or a list of sequences.  ``mesh`` (this
    rank's ``parallel.sharded.Mesh``) is passed to every round, as in the
    JAX package; each rank then gets rank 0's straights to re-seed the
    next round."""
    if mesh is not None:
        device = mesh.device
    check_device(device, "assemble_multik")
    ks = tuple(config.k_list) or (config.k,)
    reads = list(source) if isinstance(source, (list, tuple)) else source
    if streaming:
        from platanus3_tpu_torch.streaming import assemble_streaming

    res = None
    for i, k in enumerate(ks):
        cfg_k = dataclasses.replace(config, k=k, k_list=())
        extra = None
        if res is not None:
            extra = [s for s in res.straight_seqs if len(s) >= k]
        last = i == len(ks) - 1
        if streaming:
            res = assemble_streaming(reads, cfg_k, log=log, mesh=mesh,
                                     write_output=write_output and last,
                                     slice_chunks=slice_chunks,
                                     extra_solid=extra or None, device=device)
        else:
            res = assemble(reads, cfg_k, log=log, mesh=mesh,
                           write_output=write_output and last,
                           extra_solid=extra or None, device=device)
        if log:
            log.write(f"multi-k round k={k}: {res.num_straights} straights, "
                      f"{res.num_junctions} junctions")
    return res
