"""Stage timer and device trace for the pipeline.

Port of ``platanus3_tpu/utils/profiling.py``.  ``device_trace`` wraps a
run in a ``torch.profiler`` trace (CPU activity, plus CUDA activity on
the card) and writes it into ``trace_dir`` as a Chrome trace
(``trace.json``, readable by Perfetto or ``chrome://tracing``).  It is
the counterpart of the JAX package's ``jax.profiler`` trace.

``StageTimer`` is the port of the JAX package's.  With
``barriers`` on, each mark first waits for the device
(``torch.cuda.synchronize()``), so a span measures finished device work
rather than enqueued work.  On a CUDA device it also records the peak
device memory allocated during each span
(``torch.cuda.max_memory_allocated``) and the most the caching allocator
held (``torch.cuda.max_memory_reserved``).  ``part`` splits the span in
progress into named parts, each a span of its own.  ``counters`` names
process-wide counts (a zero-argument function each, such as a kernel's
launch count); ``counts`` gives how far each rose since the timer began.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["StageTimer", "device_trace", "TRACE_FILE", "TRACE_WINDOW"]

TRACE_FILE = "trace.json"
# Name of the CPU event that spans the whole traced region.
TRACE_WINDOW = "p3_traced_run"


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device="cpu"):
    """Trace the enclosed region into ``trace_dir/trace.json`` (no-op
    when ``trace_dir`` is falsy): CPU activity always, CUDA activity
    when ``device`` is a CUDA device.  One CPU event named
    ``TRACE_WINDOW`` spans the region, host-only work (the read load)
    included, so the device's idle share of the whole run can be read
    off the trace."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(TRACE_WINDOW):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class StageTimer:
    def __init__(self, barriers: bool = False, device="cpu",
                 counters=None):
        self.spans = {}
        self.peak_bytes = {}
        self.reserved_bytes = {}
        self.counters = dict(counters or {})
        self._counts0 = {name: read() for name, read in self.counters.items()}
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
            held = torch.cuda.max_memory_reserved(self.device)
            self.reserved_bytes[name] = max(self.reserved_bytes.get(name, 0),
                                            held)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._last = self._part_last = now

    def counts(self) -> dict:
        """Each counter's rise since the timer began."""
        return {name: read() - self._counts0[name]
                for name, read in self.counters.items()}

    def part(self, name: str):
        """Record the time since the previous mark or part as span
        ``name``, a part of the span the next mark closes; its peak
        memory is not recorded."""
        if self.barriers and self._cuda:
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.spans[name] = self.spans.get(name, 0.0) + now - self._part_last
        self._part_last = now
