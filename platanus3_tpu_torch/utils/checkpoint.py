"""Stage checkpointing / resume.

Port of ``platanus3_tpu/utils/checkpoint.py``.  A pipeline's stage
boundaries are its checkpoints: each stage's output tensors are written
as one ``.npz`` in a directory named by a digest of the inputs and the
configuration, so a re-run with the same inputs skips to the first
missing stage.  Named tuples (``DBG``, ``CoverageResult``, ``KmerTable``)
are stored leaf by leaf through their ``_fields``; dtypes are kept
(int64 lanes and ids, bool masks, int32 Bloom words), and ``load``
returns tensors on the caller's device.

Saves are atomic (write, then rename).  ``P3_FAULT_AFTER=<stage>`` kills
the process with exit code 137 right after that stage's checkpoint lands,
so tests can crash a run mid-pipeline and resume it.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "digest_of", "tuple_arrays", "tuple_from"]


def digest_of(arr) -> str:
    """Short sha256 of an array's bytes (an input digest part)."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    def __init__(self, directory: Optional[str], digest_parts=()):
        self.dir = directory or None
        self.digest = hashlib.sha256(
            json.dumps([str(p) for p in digest_parts]).encode()
        ).hexdigest()[:16]
        if self.dir:
            os.makedirs(os.path.join(self.dir, self.digest), exist_ok=True)

    def _path(self, stage: str) -> Optional[str]:
        if not self.dir:
            return None
        return os.path.join(self.dir, self.digest, f"{stage}.npz")

    def has(self, stage: str) -> bool:
        p = self._path(stage)
        return bool(p) and os.path.exists(p)

    def save(self, stage: str, **arrays):
        """Write ``arrays`` (tensors or arrays) as stage ``stage``."""
        p = self._path(stage)
        if not p:
            return
        np.savez_compressed(p + ".tmp.npz",
                            **{k: _to_numpy(v) for k, v in arrays.items()})
        os.replace(p + ".tmp.npz", p)
        if os.environ.get("P3_FAULT_AFTER") == stage:
            os._exit(137)

    def load(self, stage: str, device="cpu") -> Optional[dict]:
        """Stage ``stage`` as a dict of tensors on ``device`` (None when
        absent)."""
        p = self._path(stage)
        if not p or not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def tuple_arrays(prefix: str, tup) -> dict:
    """A named tuple's leaves as ``{prefix.field: leaf}``."""
    return {f"{prefix}.{f}": getattr(tup, f) for f in tup._fields}


def tuple_from(cls, prefix: str, arrays: dict):
    """The named tuple ``cls`` from :func:`tuple_arrays`' keys."""
    return cls(*[arrays[f"{prefix}.{f}"] for f in cls._fields])
