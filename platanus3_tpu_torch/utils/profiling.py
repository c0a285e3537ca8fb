"""Stage timer and device trace for the pipeline.

Port of ``platanus3_tpu/utils/profiling.py``.  ``device_trace`` wraps a
run in a ``torch.profiler`` trace (CPU activity, plus CUDA activity on
the card) and writes it into ``trace_dir`` as a Chrome trace
(``trace.json``, readable by Perfetto or ``chrome://tracing``).  It is
the counterpart of the JAX package's ``jax.profiler`` trace.

``StageTimer`` times a run as named spans, each named where it starts:
``begin(name)`` closes the span in progress and opens span ``name``,
``end()`` closes it, and ``with timer.part(name):`` times a part of the
span in progress, a span of its own nested in it.  Spans are timed with
``time.perf_counter``; while a ``torch.profiler`` records, each span and
part is also a ``record_function`` range ``p3.<name>`` on the trace's
clock.  ``spans`` maps each name to its seconds, summed over repeats, in
the order the spans first opened.  ``counters`` names process-wide counts
(a zero-argument function each, such as a kernel's launch count);
``span_counts`` holds each one's rise over every span and part, and
``counts()`` its rise since the timer began, with the values ``note``
set.

With ``profile`` on (``--profile-stages``) each span and part starts and
ends with ``torch.cuda.synchronize()``, so it measures finished device
work rather than enqueued work.  On a CUDA device the timer then also
records each span's peak device memory allocated
(``torch.cuda.max_memory_allocated``) and held by the caching allocator
(``torch.cuda.max_memory_reserved``) in ``peak_bytes`` /
``reserved_bytes``, and adds the counter ``host_syncs``: the operations
that made the host wait for the device, counted from the warnings of
PyTorch's sync debug mode, the timer's own barriers left out.  With
``profile`` off the timer touches no process-wide state: it neither
resets nor reads the peak memory statistics, leaves the sync debug mode
alone, and opens a range only while a profiler records.  The timer is a
context manager: leaving it closes what is open and restores the sync
debug mode and the warning filters, on error too.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch
from torch.profiler import record_function

__all__ = ["StageTimer", "device_trace", "timed_part", "TRACE_FILE",
           "TRACE_WINDOW", "RANGE_PREFIX", "SYNC_WARNING"]

TRACE_FILE = "trace.json"
# Name of the CPU event that spans the whole traced region.
TRACE_WINDOW = "p3_traced_run"
# Prefix of the profiler range of each span and part.
RANGE_PREFIX = "p3."
# What PyTorch's sync debug mode says of each synchronizing operation.
SYNC_WARNING = "called a synchronizing CUDA operation"


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
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(TRACE_WINDOW):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def timed_part(timer, name: str):
    """``timer.part(name)``, or nothing where ``timer`` is None (code that
    also runs outside a timed run)."""
    return contextlib.nullcontext() if timer is None else timer.part(name)


def _recording() -> bool:
    """Whether a ``torch.profiler`` records: a cheap check, where an
    unguarded ``record_function`` costs microseconds with none."""
    return torch._C._autograd._profiler_enabled()


class StageTimer:
    def __init__(self, profile: bool = False, device="cpu", counters=None):
        self.profile = profile
        self.device = torch.device(device)
        self._watch = profile and self.device.type == "cuda"
        self.spans, self.span_counts = {}, {}
        self.peak_bytes, self.reserved_bytes = {}, {}
        self.host_syncs = 0
        self.notes = {}
        self.counters = dict(counters or {})
        if self._watch:
            self.counters["host_syncs"] = lambda: self.host_syncs
        self._counts0 = self._read()
        self._open = []         # the span in progress, then its open parts
        self.t0 = self.t1 = None
        self._restore = contextlib.ExitStack()

    def __enter__(self):
        if self._watch:
            with contextlib.ExitStack() as stack:
                stack.enter_context(warnings.catch_warnings())
                warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
                show = warnings.showwarning

                def count(message, *args, **kwargs):
                    if SYNC_WARNING in str(message):
                        self.host_syncs += 1
                    else:
                        show(message, *args, **kwargs)

                warnings.showwarning = count
                stack.callback(torch.cuda.set_sync_debug_mode,
                               torch.cuda.get_sync_debug_mode())
                torch.cuda.set_sync_debug_mode("warn")
                self._restore = stack.pop_all()
        return self

    def __exit__(self, exc_type, *exc):
        try:
            while self._open:
                self._close(sync=exc_type is None)
        finally:
            self._restore.close()

    def begin(self, name: str):
        """Close the span in progress, if any, and open span ``name``
        where it ended, so that the spans tile the run."""
        self.end()
        self._start(name, span=True, at=self.t1)

    def end(self):
        """Close the span in progress and its open parts."""
        while self._open:
            self._close()

    @contextlib.contextmanager
    def part(self, name: str):
        """Time the enclosed code as part ``name`` of the span in
        progress; its peak memory is not recorded."""
        self._start(name, span=False)
        ok = False
        try:
            yield
            ok = True
        finally:
            self._close(sync=ok)

    def counts(self) -> dict:
        """Each counter's rise since the timer began, then each ``note``'s
        value."""
        out = {name: v - self._counts0[name]
               for name, v in self._read().items()}
        syncs = self.host_syncs
        out.update({name: int(count()) for name, count in self.notes.items()})
        self.host_syncs = syncs
        return out

    def note(self, name: str, count):
        """With ``profile`` on, give ``counts()`` the entry ``name``:
        ``int(count())``, read when ``counts()`` is, at the end of the run
        (``count`` is a zero-argument function, such as a sum on the
        device), so that its work and the host's wait for it fall in no
        stage; they are the timer's own, as its barriers are, and left
        out of ``host_syncs``.  With ``profile`` off, do nothing."""
        if self.profile:
            self.notes[name] = count

    def elapsed(self) -> float:
        """Seconds from the first span's start to the last close, or to
        now while a span is open."""
        if self.t0 is None:
            return 0.0
        return (time.perf_counter() if self._open else self.t1) - self.t0

    def _read(self) -> dict:
        return {name: read() for name, read in self.counters.items()}

    def _barrier(self):
        if self._watch:
            syncs = self.host_syncs
            torch.cuda.synchronize(self.device)
            self.host_syncs = syncs

    def _start(self, name, span, at=None):
        # The range opens first and closes last, so that it holds the
        # timer's own work as the span does.
        rng = None
        if _recording():
            rng = record_function(RANGE_PREFIX + name)
            rng.__enter__()
        self._barrier()
        if span and self._watch:
            torch.cuda.reset_peak_memory_stats(self.device)
        counts = self._read()
        self.spans.setdefault(name, 0.0)
        now = time.perf_counter() if at is None else at
        if self.t0 is None:
            self.t0 = now
        self._open.append((name, span, now, counts, rng))

    def _close(self, sync=True):
        name, span, start, counts, rng = self._open.pop()
        if sync:
            self._barrier()
        self.t1 = time.perf_counter()
        self.spans[name] += self.t1 - start
        rise = self.span_counts.setdefault(name,
                                           dict.fromkeys(self.counters, 0))
        for c, v in self._read().items():
            rise[c] += v - counts[c]
        if span and self._watch:
            self.peak_bytes[name] = max(self.peak_bytes.get(name, 0),
                                        torch.cuda.max_memory_allocated(
                                            self.device))
            self.reserved_bytes[name] = max(
                self.reserved_bytes.get(name, 0),
                torch.cuda.max_memory_reserved(self.device))
        if rng is not None:
            rng.__exit__(None, None, None)
