"""A tiny cell end to end on the CPU: the port against the plain reference,
the faults that have to turn ``correct`` false, the control, and no JAX."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from asmbench import control, run
from asmbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("config", [tiny.SINGLE, tiny.STREAMING],
                         ids=["single", "streaming"])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_tiny_cell_is_correct(tmp_path, config, trace):
    cell = tiny.cell(config)
    r = run.run_cell(cell, 5, 0.5, trace, device="cpu", workdir=tmp_path)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in r["check"].values())
    names = set(r["metrics"])
    if trace:
        assert {"cold_job_s", "load_s", "graph_s", "coverage_s",
                "emit_s"} <= names
        assert ("passes_s" in names) == config["params"]["streaming"]
        assert ("stage1_s" in names) != config["params"]["streaming"]
        # The CPU has no device trace, so no device metric is read.
        assert "device_idle_share" not in names
        assert "bloom_set_bits_roofline" not in names
        assert r["device"]["window_s"] > 0
    else:
        assert names == {"asm_mbases_per_s", "peak_device_gb", "setup_s"}
        assert r["metrics"]["asm_mbases_per_s"]["value"] > 0


def _cli_main():
    from platanus3_tpu_torch import cli
    return cli.main


def _unchanged(argv):
    """The job returns without assembling: no GFA is written."""
    return 0


def _half_batch(argv):
    """The job assembles half of the reads."""
    i = argv.index("-i") + 1
    src = Path(argv[i])
    lines = src.read_text().splitlines()
    half = src.with_name("half.fasta")
    half.write_text("\n".join(lines[:len(lines) // 4 * 2]) + "\n")
    return _cli_main()(argv[:i] + [str(half)] + argv[i + 1:])


def _altered(argv):
    """The job's answer has one base altered where it is written."""
    rc = _cli_main()(argv)
    gfa = Path(argv[argv.index("-o") + 1])
    lines = gfa.read_text().split("\n")
    at = next(i for i, ln in enumerate(lines) if ln.startswith("S\tStraight"))
    f = lines[at].split("\t")
    f[2] = ("C" if f[2][0] != "C" else "G") + f[2][1:]
    lines[at] = "\t".join(f)
    gfa.write_text("\n".join(lines))
    return rc


def _coverage_off(argv):
    """The job's junction coverage is off by one read."""
    rc = _cli_main()(argv)
    gfa = Path(argv[argv.index("-o") + 1])
    lines = gfa.read_text().split("\n")
    at = next(i for i, ln in enumerate(lines) if ln.startswith("S\tJunction"))
    f = lines[at].split("\t")
    f[3] = f"KC:i:{int(f[3].split(':')[2]) + 32}"
    lines[at] = "\t".join(f)
    gfa.write_text("\n".join(lines))
    return rc


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _coverage_off],
                         ids=["unchanged", "half_batch", "altered",
                              "coverage_off"])
def test_broken_timed_path_is_not_correct(tmp_path, fault):
    calls = []

    def job(argv):
        calls.append(argv)
        # The cold job is set-up: break only the window's jobs.
        return _cli_main()(argv) if len(calls) == 1 else fault(argv)

    r = run.run_cell(tiny.cell(), 6, 0.5, False, device="cpu", job=job,
                     workdir=tmp_path)
    assert not r["correct"]
    assert r["check"]["jobs_differ"]["value"] == r["attempted"] >= 1
    assert r["check"]["lines_differ"]["value"] > 0


def test_control_fails_at_the_cells_load():
    """The control (nodes told apart by a fingerprint of their key) at
    the test size: 25 bits give its ~38k nodes the load that 32 bits give
    E. coli's 4.6M nodes (about 1e-3 nodes a fingerprint value)."""
    checks = control.control_checks(tiny.cell(), 5, "cpu", node_key_bits=25)
    assert any(c["value"] > c["limit"] for c in checks.values())
    assert checks["jobs_differ"]["value"] == 1


def test_no_jax_after_set_up(tmp_path):
    """A cell's whole run loads neither JAX nor the JAX package (whole
    top-level names: ``platanus3_tpu_torch`` is another)."""
    code = (
        "import json, sys; from pathlib import Path\n"
        "from asmbench import run; from asmbench.tests import tiny\n"
        f"r = run.run_cell(tiny.cell(), 7, 0.1, False, device='cpu', "
        f"workdir=Path({str(tmp_path)!r}))\n"
        "print(json.dumps({'correct': r['correct'], 'bad': "
        "run.forbidden_loaded(), 'port': 'platanus3_tpu_torch' in "
        "sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "port": True}


def test_jax_loaded_after_the_window_withholds_the_result(tmp_path):
    """A per-layer reader that imports a module named ``jax`` once the
    window has closed: the run names it, exits with 3, prints no
    result."""
    fake, home = tmp_path / "fake", tmp_path / "asmbench"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    (home / "metrics").mkdir(parents=True)
    shutil.copytree(tiny.HOME / "references", home / "references")
    (home / "metrics" / "planted.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    code = (
        "import dataclasses, sys; from pathlib import Path\n"
        f"sys.path.insert(0, {str(fake)!r})\n"
        "from asmbench import run; from asmbench.tests import tiny\n"
        "cell = dataclasses.replace(\n"
        f"    tiny.cell(), home=Path({str(home)!r}),\n"
        "    per_layer=[{'name': 'planted', 'unit': 'x'}])\n"
        "r = run.run_cell(cell, 7, 0.1, True, device='cpu', "
        f"workdir=Path({str(tmp_path / 'work')!r}))\n"
        "sys.exit(run.report(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-3000:]
    assert '"correct"' not in out.stdout     # no result line
    assert "loaded once the window closed: jax" in out.stderr


def test_forbidden_names_are_whole_top_level_names():
    mods = {"platanus3_tpu_torch": 1, "platanus3_tpu_torch.cli": 1,
            "jaxtyping": 1, "platanus3_tpu.ops": 1, "jax": 1,
            "flax.linen": 1}
    assert run.forbidden_loaded(mods) == ["flax.linen", "jax",
                                          "platanus3_tpu.ops"]


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "ecoli_k12.hifi20x", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
