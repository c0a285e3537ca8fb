"""Card-only tests: a tiny cell through the whole harness on the card,
traced, and the reference on the card against the reference on the CPU.

Run on the card with ``python -m pytest -m cuda asmbench/tests``; they
skip where there is no card."""

from __future__ import annotations

import pytest

from asmbench import control, run
from asmbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("config", [tiny.SINGLE, tiny.STREAMING],
                         ids=["single", "streaming"])
def test_tiny_cell_on_the_card(card, tmp_path, config):
    r = run.run_cell(tiny.cell(config), 5, 1.0, True, device="cuda",
                     workdir=tmp_path)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    roof = r["metrics"]["bloom_set_bits_roofline"]["value"]
    assert 0 < roof <= 100
    assert 0 <= r["metrics"]["device_idle_share"]["value"] < 100
    assert r["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(card):
    cell = tiny.cell()
    codes, offs = run.make_inputs(cell, 9)
    ref = cell.reference()
    params = cell.config["params"]
    assert ref(codes, offs, params, device="cuda") == ref(
        codes, offs, params, device="cpu")


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    checks = control.control_checks(tiny.cell(), 5, "cuda", node_key_bits=25)
    assert checks["jobs_differ"]["value"] == 1
