"""``BENCHMARK.json`` and the files it names: found by name, within the
limits of the benchmark's format, and free of JAX."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from asmbench import spec
from asmbench.traffic import gen

HOME = Path(__file__).resolve().parent.parent
BENCH = json.loads(spec.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files of their own, with entries naming them, need no other edit."""
    home = tmp_path / "asmbench"
    for sub in ("configs", "traffic", "metrics"):
        (home / sub).mkdir(parents=True)
    shutil.copytree(HOME / "references", home / "references")
    (home / "configs" / "toy.json").write_text(json.dumps(
        {"genome": {"kind": "random", "length": 5000, "seed": 1}, "cli_args": [],
         "params": {"k": 25}, "reference": "debruijn"}))
    (home / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"coverage": 3, "read_len": 500, "genome_salt": 1, "reads_salt": 2}))
    (home / "metrics" / "toy_metric.v2.py").write_text(
        "def read(run):\n    return 42.0 if run else None\n")
    bench = {"paths": ["asmbench"],
             "configs": [{"name": "toy", "file": "asmbench/configs/toy.json"}],
             "workloads": [{"name": "toy.toy_mix", "config": "toy",
                            "traffic": "toy_mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "other_s", "unit": "s",
                             "workloads": ["elsewhere"]}],
             "per_layer": [{"name": "toy_metric.v2", "unit": "%",
                            "workloads": ["toy.toy_mix"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("toy.toy_mix", tmp_path / "BENCHMARK.json")
    assert cell.config["params"] == {"k": 25}
    assert cell.traffic["read_len"] == 500
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert cell.reader("toy_metric.v2")(object()) == 42.0
    assert callable(cell.reference())
    with pytest.raises(KeyError):
        spec.load_cell("nope", tmp_path / "BENCHMARK.json")


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["asmbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "asmbench.run"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits into its 43200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("asmbench/")
        assert all(NAME.match(r) for r in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        conf = json.loads((HOME.parent / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in cells and w["config"] in names
        cells.add(w["name"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (HOME / "traffic" / f"{w['traffic']}.json").is_file()
    assert {w["config"] for w in BENCH["workloads"]} == names
    metric_names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metric_names
        metric_names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (HOME / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        assert any("workloads" not in m or cell in m["workloads"]
                   for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_params_are_its_cli_arguments(config):
    """The parameters the reference and the yardstick read are the ones
    the job runs with."""
    from platanus3_tpu_torch import cli
    conf = json.loads((HOME / "configs" / f"{config}.json").read_text())
    a = cli.build_parser().parse_args(["-i", "x.fasta", *conf["cli_args"]])
    p = conf["params"]
    assert (a.k, a.short_k, a.cov_threshold, a.chunk_len, a.filter_bits) == (
        p["k"], p["short_k"], p["cov_threshold"], p["chunk_len"],
        p["filter_bits"])
    assert a.streaming == p["streaming"] and a.membership == p["membership"]
    if p["streaming"]:
        assert a.slice_chunks == p["slice_chunks"]
    assert p["k"] <= 32   # the reference holds a k-mer in one int64


@pytest.mark.parametrize("workload,reads,bases", [
    ("ecoli_k12.hifi20x", 6_876, 92_896_437),
    ("chr21_stream_exact.hifi12x", 41_519, 561_006_389),
    ("ecoli_k12.hifi10x", 3_438, 46_427_246)])
def test_cell_sizes(workload, reads, bases):
    """Each cell's read lengths (before indels), fixed by its genome."""
    cell = spec.load_cell(workload)
    g = cell.config["genome"]
    lens = gen.read_lengths(g["length"], cell.traffic,
                            gen.make_rng(g["seed"],
                                         cell.traffic["lengths_salt"]))
    assert lens.shape[0] == reads and int(lens.sum()) == bases
    assert abs(lens.mean() / cell.traffic["read_len"] - 1) < 0.01
    assert abs(lens.std() / cell.traffic["read_len_sd"] - 1) < 0.05
    assert lens.min() >= cell.traffic["min_read_len"]


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (HOME / "traffic").glob("*.json")))
def test_traffic_mixes_cite_their_source(traffic):
    mix = json.loads((HOME / "traffic" / f"{traffic}.json").read_text())
    assert mix["source"] and mix["assumed"]
    assert mix["ins_rate"] > 0 and mix["del_rate"] > 0
    assert mix["read_len_sd"] > 0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in HOME.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "platanus3_tpu",
                               "benchmarks", "bench"), (path, mod)


def test_references_import_nothing_of_the_program():
    for path in (HOME / "references").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "dataclasses",
                                         "numpy", "torch"), (
                path, mod)
