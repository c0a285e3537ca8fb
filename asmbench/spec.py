"""What ``BENCHMARK.json`` names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or reference is a file of its own beside this module, so that a
cell or a metric is added by adding files and entries:

* ``configs/<config>.json``: the file an entry of ``configs`` names;
* ``traffic/<traffic>.json``: a traffic mix's parameters;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
* ``references/<reference>.py``: a configuration's plain reference,
  ``reference(codes, offs, params, device, node_key_bits)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["Cell", "load_cell", "load_module", "BENCHMARK"]

BENCHMARK = Path(__file__).resolve().parent.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    workload: dict        # the entry of ``workloads``
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # entries reported with --trace 0
    per_layer: list       # entries reported with --trace 1
    home: Path            # the harness folder the names resolve in

    @property
    def name(self) -> str:
        return self.workload["name"]

    def reader(self, metric: str):
        return load_module(self.home / "metrics" / f"{metric}.py").read

    def reference(self):
        name = self.config["reference"]
        return load_module(self.home / "references" / f"{name}.py").reference


def load_module(path: Path):
    """Import a file by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "asmbench_file_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, benchmark: Path = BENCHMARK) -> Cell:
    bench = json.loads(Path(benchmark).read_text())
    repo = Path(benchmark).resolve().parent
    home = repo / bench["paths"][0]
    (entry,) = [w for w in bench["workloads"] if w["name"] == workload] or [
        None]
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    (conf,) = [c for c in bench["configs"] if c["name"] == entry["config"]]
    config = json.loads((repo / conf["file"]).read_text())
    traffic = json.loads(
        (home / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(workload=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)],
                home=home)
