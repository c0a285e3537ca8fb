"""Sliding-window minimum via doubling (sparse-table) decomposition.

Port of ``platanus3_tpu/ops/windowmin.py``: ``out[j] = min(v[j:j+w])``
over the last axis from O(log w) shifted elementwise minima.  Turns
per-position short-k-mer counts into the conservative coverage estimate
of each large k-mer (reference ``src/MakeBloomFilter.cpp:62``).
"""

from __future__ import annotations

import torch

__all__ = ["window_min"]


def window_min(values: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed min over the last axis, VALID padding:
    ``[..., P] -> [..., P - window + 1]``."""
    assert window >= 1
    if window == 1:
        return values
    assert values.shape[-1] >= window
    p = 1
    m = values
    while p * 2 <= window:
        m = torch.minimum(m[..., :m.shape[-1] - p], m[..., p:])
        p *= 2
    # m[j] = min(v[j:j+p]) with w/2 < p <= w: two overlapping p-windows
    # starting at j and j + w - p cover [j, j + w) exactly.
    out_len = values.shape[-1] - window + 1
    return torch.minimum(m[..., :out_len],
                         m[..., window - p:window - p + out_len])
