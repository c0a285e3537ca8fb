"""Multi-k iterative assembly (BASELINE config 4).

Port of ``platanus3_tpu/graph/multik.py``: assemble at increasing k (e.g.
32 -> 64 -> 128), re-seeding each round's graph with the previous round's
unitigs through ``pipeline.assemble``'s ``extra_solid`` hook.  Their
k-mers join the next round's node table and their first k-mers its seeds,
bypassing the solidity filter without touching the read batch, so the
reads are parsed once and coverage stays read-derived.
"""

from __future__ import annotations

import dataclasses

from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.io import reads as reads_mod
from platanus3_tpu_torch.pipeline import AssemblyResult, assemble

__all__ = ["assemble_multik"]


def assemble_multik(source, config: AssemblyConfig, log=None, mesh=None,
                    write_output: bool = True, streaming: bool = False,
                    device="cuda") -> AssemblyResult:
    """Iterate assembly over ``config.k_list`` on ``device``, re-seeding
    each round with the previous round's unitigs via ``extra_solid``;
    returns the last round's result.  ``streaming`` and ``mesh`` are not
    ported yet."""
    if streaming:
        raise NotImplementedError("streaming multi-k: the streaming "
                                  "pipeline is not ported yet (ROADMAP.md "
                                  "Queue 1 item 3)")
    ks = tuple(config.k_list) or (config.k,)
    if isinstance(source, (list, tuple)):
        reads = list(source)
    else:
        reads = reads_mod.parse_reads(source)

    res = None
    for i, k in enumerate(ks):
        cfg_k = dataclasses.replace(config, k=k, k_list=())
        extra = None
        if res is not None:
            extra = [s for s in res.straight_seqs if len(s) >= k]
        res = assemble(reads, cfg_k, log=log, mesh=mesh,
                       write_output=write_output and i == len(ks) - 1,
                       extra_solid=extra or None, device=device)
        if log:
            log.write(f"multi-k round k={k}: {res.num_straights} straights, "
                      f"{res.num_junctions} junctions")
    return res
