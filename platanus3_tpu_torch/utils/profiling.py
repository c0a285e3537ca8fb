"""Stage timer for the pipeline.

Port of ``StageTimer`` from ``platanus3_tpu/utils/profiling.py``.  With
``barriers`` on, each mark first waits for the device
(``torch.cuda.synchronize()``), so a span measures finished device work
rather than enqueued work.  On a CUDA device it also records the peak
device memory allocated during each span
(``torch.cuda.max_memory_allocated``).  ``part`` splits the span in
progress into named parts, each a span of its own.
"""

from __future__ import annotations

import time

import torch

__all__ = ["StageTimer"]


class StageTimer:
    def __init__(self, barriers: bool = False, device="cpu"):
        self.spans = {}
        self.peak_bytes = {}
        self.barriers = barriers
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self._last = self._part_last = time.time()

    def mark(self, name: str):
        """Record the time (and peak device memory) since the previous
        mark as span ``name``."""
        if self.barriers and self._cuda:
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.spans[name] = self.spans.get(name, 0.0) + now - self._last
        if self._cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.peak_bytes[name] = max(self.peak_bytes.get(name, 0), peak)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._last = self._part_last = now

    def part(self, name: str):
        """Record the time since the previous mark or part as span
        ``name``, a part of the span the next mark closes; its peak
        memory is not recorded."""
        if self.barriers and self._cuda:
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.spans[name] = self.spans.get(name, 0.0) + now - self._part_last
        self._part_last = now
