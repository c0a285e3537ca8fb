"""Share of the traced jobs' window in which no kernel, copy or set ran on
the device, in percent (``trace.py``)."""


def read(run):
    t = run.trace
    if t is None or t.device_events == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
