"""Streaming over a mesh in the port against the JAX package's, the GFA
line for line, tolerance "exact".

Four gloo ranks on the CPU (``torch_mesh_worker.launch``, one launch, a
300 s timeout) run ``streaming.assemble_streaming(mesh=...)`` on the
inputs of ``tests/test_streaming.py``'s mesh tests: the random genome,
the repeat genome with tips and bubbles, and the random genome in Bloom
membership.  The JAX package's streaming runs here on a 4-device mesh;
the port's single-device streaming runs here too.  A tiny ``short_cap``
must raise JAX's message on every rank; the restore of the ``spass2`` and
``stage3`` checkpoints over a mesh must give the same GFA; multi-k over
the mesh, single shot, must equal the JAX package's (its
``sharded_stage1`` through ``jax.jit``, ``jax_mesh_reference``), and
multi-k streaming over the mesh the port's single-device multi-k
streaming.
"""

import pytest

import jax_mesh_reference as reference
import torch_mesh_worker as worker
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.graph.multik import assemble_multik as j_multik
from platanus3_tpu.streaming import assemble_streaming as j_streaming
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.graph.multik import assemble_multik as t_multik
from platanus3_tpu_torch.streaming import assemble_streaming as t_streaming

CASES = tuple(worker.streaming_cases())
SCENARIOS = [*CASES, "tiny_short_cap", "stream_restore", "multik",
             "multik_streaming", "stream_root_fails"]
# JAX's message (platanus3_tpu/streaming.py), the row count aside.
SHORT_CAP_MESSAGE = ("sharded short-table overflow (", " rows); re-run with "
                     "larger short_cap / slack")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch(tmp_path_factory.mktemp("streaming_mesh"), SCENARIOS)


@pytest.mark.parametrize("case", CASES)
def test_streaming_mesh_matches_jax(ranks, case):
    reads, kw, slice_chunks = worker.streaming_cases()[case]
    mesh = reference.make_mesh(4)
    j = j_streaming(reads, JConfig(log_path=None, **kw), write_output=False,
                    slice_chunks=slice_chunks, mesh=mesh)
    t = t_streaming(reads, TConfig(log_path=None, **kw), write_output=False,
                    slice_chunks=slice_chunks, device="cpu")
    assert t.gfa_lines == j.gfa_lines
    for got in ranks[case]:
        assert got["gfa"] == j.gfa_lines
        assert got["num_nodes"] == j.num_nodes
        assert got["stats"] == ranks[case][0]["stats"]
    assert t.num_straights >= 1
    stats = ranks[case][0]["stats"]
    per_rank = stats["mesh"]["ranks"]
    assert [r["rank"] for r in per_rank] == [0, 1, 2, 3]
    assert all(r["traffic_bytes"]["pass1 route"] > 0 for r in per_rank)
    assert {"pass1", "pass2", "pass2_table", "graph", "coverage"} <= \
        set(stats["stages"])


def test_tiny_short_cap_raises_on_every_rank(ranks):
    errors = [r["error"] for r in ranks["tiny_short_cap"]]
    head, tail = SHORT_CAP_MESSAGE
    for e in errors:
        assert e is not None and e.startswith(head) and e.endswith(tail)
        assert int(e[len(head):-len(tail)]) > 0
    assert len(set(errors)) == 1


def test_checkpoint_restores_over_the_mesh(ranks):
    for got in ranks["stream_restore"]:
        fresh, spass2, stage3 = got["gfa"]
        assert fresh == spass2 == stage3 == ranks["stream_repeat_simplify"][
            0]["gfa"]
    stages = ranks["stream_restore"][0]["stages"]
    assert "pass1" in stages[0] and "pass1" not in stages[1]
    assert "restore_spass2" in stages[1] and "restore" in stages[2]


def test_multik_mesh_matches_jax(ranks, monkeypatch):
    reads, kw = worker.multik_case()
    reference.jit_sharded_stage1(monkeypatch)
    j = j_multik(reads, JConfig(log_path=None, **kw), write_output=False,
                 mesh=reference.make_mesh(4))
    assert j.num_straights >= 1
    for got in ranks["multik"]:
        assert got["gfa"] == j.gfa_lines
        assert got["stats"]["k"] == kw["k_list"][-1]


def test_multik_streaming_mesh_equals_single_device(ranks):
    reads, kw = worker.multik_case()
    t = t_multik(reads, TConfig(log_path=None, **kw), write_output=False,
                 streaming=True, slice_chunks=16, device="cpu")
    assert t.num_straights >= 1
    for got in ranks["multik_streaming"]:
        assert got["gfa"] == t.gfa_lines
        assert got["stats"]["k"] == kw["k_list"][-1]


def test_rank0_failure_reaches_every_rank(ranks):
    """Rank 0 cannot write the GFA after the last coverage pass: the other
    ranks raise its error instead of waiting in a collective."""
    root, *others = [r["error"] for r in ranks["stream_root_fails"]]
    assert root is not None and root.startswith("FileNotFoundError: ")
    assert others == [f"RuntimeError: rank 0 failed: {root}"] * 3
