"""Pipeline logging & metrics.

Replaces the reference's ``Logging`` class (``src/Logging.cpp``) which
opens/closes ``./platanus3.log`` per line under a mutex and is called per
graph NODE during traversal -- a measured serial bottleneck (SURVEY.md
§5: ~550 KB of log for a 3 kb genome).  Here: stage-level lines, and a
line a named count (``metric``) where the reference logged per node; each
line is appended to the file as it is written.  File format stays
line-per-event so existing habits work.

Under a mesh of ranks (``parallel/sharded.py``) only rank 0 echoes and
writes the file; the other ranks drop their lines.
"""

from __future__ import annotations

import time
from typing import Optional

import torch.distributed as dist


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class PipelineLog:
    def __init__(self, path: Optional[str] = "./platanus3.log",
                 echo: bool = False):
        self.path = path
        self.echo = echo
        self.lines = []
        self._t0 = time.time()

    def write(self, text: str):
        line = f"[{time.time() - self._t0:8.2f}s] {text}"
        if not _is_writer():
            return
        self.lines.append(line)
        if self.echo:
            print(line, flush=True)
        self.flush()

    def metric(self, name: str, value):
        self.write(f"{name} : {value}")

    def flush(self):
        if self.path and self.lines:
            with open(self.path, "a") as f:
                f.write("\n".join(self.lines) + "\n")
        self.lines = []
