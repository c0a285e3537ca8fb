"""Solid-k-mer threshold sweep over error-prone reads (BASELINE config 2).

Port of ``platanus3_tpu/sweep.py``.  The threshold enters stage 1 only as
the final comparison ``window_min >= t``, so ONE counting pass answers
every threshold: count + window-min once -> each unique k-mer's MAX
window-min coverage (one more sort and a segment max, ``scatter_reduce_``
with ``amax``) -> the solid set at ``t`` is ``max_cov >= t``.

Against a truth genome the sweep reports the precision and recall of the
solid set, and with ``assemble_each`` the assembly statistics of each
threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from platanus3_tpu_torch import pipeline
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import solid as solid_mod

__all__ = ["solid_threshold_sweep", "n50"]


def n50(lengths) -> int:
    """N50 of a length list: the largest L such that contigs >= L cover
    half the total assembled bases."""
    ls = sorted((int(x) for x in lengths), reverse=True)
    total = sum(ls)
    if total == 0:
        return 0
    acc = 0
    for x in ls:
        acc += x
        if 2 * acc >= total:
            return x
    return ls[-1]


def _kmer_max_cov(packed, valid_len, read_id, start, read_len, *, k,
                  short_k):
    """Unique canonical owned k-mers with their MAX window-min coverage.

    Returns ``(keys [N, L], max_cov [N], size)``: rows below ``size`` are
    the sorted unique k-mers, rows from ``size`` on all-ones keys with
    ``max_cov`` -1 -- the sufficient statistic for every threshold."""
    result = solid_mod.solid_kmers(
        (packed, valid_len, read_id, start, read_len), k, short_k, 1,
        need_short_table=False)
    l = result.canon.shape[-1]
    canon = result.canon.reshape(-1, l)
    owned = result.owned.reshape(-1)
    cov = result.cov_est.reshape(-1).to(torch.int64)
    del result
    s_okey, s_invalid, perm = count_mod.sort_kmers(canon, ~owned, k=k)
    first = count_mod.run_starts(s_okey, s_invalid)
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    n = canon.shape[0]
    max_cov = torch.full((n,), -1, dtype=torch.int64, device=canon.device)
    max_cov.scatter_reduce_(0, seg, torch.where(s_invalid, -1, cov[perm]),
                            reduce="amax")
    uniq = first & ~s_invalid
    size = int(uniq.sum())
    keys = torch.full_like(canon, 0xFFFFFFFF)
    keys[:size] = count_mod.key_lanes(s_okey[uniq], l)
    max_cov[size:] = -1
    return keys, max_cov, size


def solid_threshold_sweep(source, config: AssemblyConfig, thresholds,
                          truth_genome: Optional[str] = None,
                          assemble_each: bool = False,
                          device="cuda") -> list:
    """Sweep ``cov_threshold`` over one read set on ``device`` (the card
    by default; ``"cpu"`` runs the plain versions; with no card the
    default raises), with one counting pass in all.

    Returns one dict per threshold with ``n_solid`` and, when
    ``truth_genome`` is given, ``precision`` / ``recall`` / ``f1`` of the
    solid k-mer set against the genome's canonical k-mer set; with
    ``assemble_each``, the assembly's statistics (straights, junctions,
    N50, max and total unitig length, nodes).
    """
    device = pipeline.check_device(device, "solid_threshold_sweep")
    batch = pipeline.load_batch(source, config)

    def dev(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    keys, max_cov, size = _kmer_max_cov(
        dev(batch.packed), dev(batch.valid_len), dev(batch.read_id),
        dev(batch.start), dev(batch.read_len), k=config.k,
        short_k=min(config.short_k, config.k))

    in_truth = None
    truth_size = 0
    if truth_genome is not None:
        from platanus3_tpu_torch.sim import genome_kmer_table
        truth = genome_kmer_table(truth_genome, config.k, device=device)
        in_truth = (count_mod.lookup_join(truth, keys) > 0).cpu().numpy()
        truth_size = int(truth.size)
        del truth

    max_cov = max_cov.cpu().numpy()
    del keys
    valid = np.arange(max_cov.shape[0]) < size

    rows = []
    for t in thresholds:
        solid = valid & (max_cov >= int(t))
        row = {"threshold": int(t), "n_solid": int(solid.sum())}
        if in_truth is not None:
            tp = int((solid & in_truth).sum())
            fp = int(solid.sum()) - tp
            row["true_kmers"] = truth_size
            row["precision"] = tp / max(1, tp + fp)
            row["recall"] = tp / max(1, truth_size)
            denom = row["precision"] + row["recall"]
            row["f1"] = (2 * row["precision"] * row["recall"] / denom
                         if denom else 0.0)
        if assemble_each:
            cfg = dataclasses.replace(config, cov_threshold=int(t))
            res = pipeline.assemble(batch, cfg, write_output=False,
                                    device=device)
            lens = [len(s) for s in res.straight_seqs if s]
            row.update({
                "straights": res.num_straights,
                "junctions": res.num_junctions,
                "n50": n50(lens),
                "max_unitig": max(lens) if lens else 0,
                "total_unitig_bases": sum(lens),
                "solid_nodes": res.num_nodes,
            })
        rows.append(row)
    return rows
