"""The port's mesh (``platanus3_tpu_torch/parallel/sharded.py``) against the
JAX package's, tolerance "exact".

Four gloo ranks on the CPU run every scenario of this file in one launch
(``torch_mesh_worker.launch``, a subprocess each with a 300 s timeout, so
a hang fails the test); each rank imports the port only.  The JAX side
runs here, on 4 of the 8 CPU devices ``tests/conftest.py`` provides, its
``sharded_stage1`` through ``jax.jit`` (``jax_mesh_reference``).  Slot
order inside a shard cannot be observed (JAX routes with an unstable
sort), so what is compared is what can be: per-position counts after the
return route, each table's keys and counts, the Bloom words, ``seed_fw``,
``has_seed`` and the GFA.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_mesh_reference as reference
import torch_mesh_worker as worker
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.ops import bloom as JB
from platanus3_tpu.ops import count as JC
from platanus3_tpu.parallel import sharded as JS
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.ops import bloom as TB
from platanus3_tpu_torch.ops import count as TC
from platanus3_tpu_torch.ops import kmer as TK
from platanus3_tpu_torch.parallel import sharded as TS
from platanus3_tpu_torch.pipeline import assemble as t_assemble

CASES = tuple(worker.assemble_cases())
SCENARIOS = ["or_allreduce", "route", "stage1", "ablate", "tiny_slack",
             "root_fails", *(f"assemble_{c}" for c in CASES)]
# JAX's message (platanus3_tpu/pipeline.py), the count of dropped k-mers
# aside.
SLACK_MESSAGE = re.compile(r"all-to-all bucket overflow \(\d+ k-mers "
                           r"dropped\); increase slack")


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch(tmp_path_factory.mktemp("sharded"), SCENARIOS)


@pytest.fixture(scope="module")
def jmesh():
    with pytest.MonkeyPatch.context() as mp:
        reference.jit_sharded_stage1(mp)
        yield reference.make_mesh(4)


def _rows(k: int):
    strings, valid, contrib = worker.route_inputs(k=k)
    return TK.encode_kmers_np(strings), valid, contrib


@pytest.mark.parametrize("k", [21, 32])
def test_count_with_positions_matches_jax(k):
    kmers, valid, contrib = _rows(k)
    jt, jp = JC.count_with_positions(jnp.asarray(kmers), jnp.asarray(valid),
                                     jnp.asarray(contrib), k=k)
    tt, tp = TC.count_with_positions(_t(kmers), torch.from_numpy(valid),
                                     torch.from_numpy(contrib), k=k)
    assert int(jt.size) == int(tt.size) > 0
    assert np.array_equal(_np(jt.keys), tt.keys.numpy())
    assert np.array_equal(_np(jt.counts), tt.counts.numpy())
    assert np.array_equal(_np(jp), tp.numpy())
    assert int(tp.max()) > 1


@pytest.mark.parametrize("cap", [600, 300])
def test_merge_into_matches_jax(cap):
    """A merge that fits and one cut to a capacity below its size (the
    size then exceeds the capacity, which is how callers see overflow)."""
    kmers, valid, _ = _rows(25)
    half = kmers.shape[0] // 2
    ja, jb = (JC.count_kmers(jnp.asarray(kmers[s]), jnp.asarray(valid[s]))
              for s in (slice(None, half), slice(half, None)))
    ta, tb = (TC.count_kmers(_t(kmers[s]), torch.from_numpy(valid[s]), k=25)
              for s in (slice(None, half), slice(half, None)))
    jm = JC.merge_into(ja, jb, cap)
    tm = TC.merge_into(ta, tb, cap)
    assert int(jm.size) == int(tm.size) > 300
    assert np.array_equal(_np(jm.keys), tm.keys.numpy())
    assert np.array_equal(_np(jm.counts), tm.counts.numpy())


def test_bloom_merge_matches_jax():
    kmers, valid, _ = _rows(25)
    half = kmers.shape[0] // 2
    js, ts = [], []
    for part in (slice(None, half), slice(half, None)):
        js.append(JB.bloom_add(JB.make_bloom(1 << 14, 3),
                               jnp.asarray(kmers[part]), 25,
                               mask=jnp.asarray(valid[part])))
        ts.append(TB.bloom_add(TB.make_bloom(1 << 14, 3), _t(kmers[part]),
                               25, mask=torch.from_numpy(valid[part])))
    jm, tm = JB.bloom_merge(*js), TB.bloom_merge(*ts)
    assert np.array_equal(np.asarray(jm.bits).view(np.int32),
                          tm.bits.numpy())
    assert (tm.log2_bits, tm.num_hashes) == (jm.log2_bits, jm.num_hashes)
    assert int(np.unpackbits(tm.bits.numpy().view(np.uint8)).sum()) > \
        int(np.unpackbits(ts[0].bits.numpy().view(np.uint8)).sum())


def test_or_allreduce_on_four_ranks(ranks):
    """1001 words, which 4 does not divide: every rank gets the OR of all
    ranks' words."""
    want = np.bitwise_or.reduce([worker.or_words(r) for r in range(4)])
    for got in ranks["or_allreduce"]:
        assert got["words"].dtype == np.int32
        assert np.array_equal(got["words"], want)


def test_routed_counts_match_count_with_positions(ranks):
    """route_to_owners + a count at the owner + route_values_back give each
    position the count of its k-mer over all ranks."""
    kmers, valid, contrib = _rows(25)
    jt, jp = JC.count_with_positions(jnp.asarray(kmers), jnp.asarray(valid),
                                     jnp.asarray(contrib), k=25)
    got = ranks["route"]
    assert all(r["overflow"] == 0 for r in got)
    assert np.array_equal(np.concatenate([r["per_pos"] for r in got]),
                          _np(jp))
    # The owners' tables are disjoint slices of the global table.
    keys = np.concatenate([r["keys"] for r in got])
    order = np.lexsort(keys.T[::-1])
    size = int(jt.size)
    assert np.array_equal(keys[order], _np(jt.keys)[:size])
    assert np.array_equal(np.concatenate([r["counts"] for r in got])[order],
                          _np(jt.counts)[:size])


def test_sharded_stage1_matches_jax(ranks, jmesh):
    batch = jreads.reads_from_strings(worker.stage1_reads(), 25, 256)
    arrays = JS.pad_batch_to_devices(
        (batch.packed, batch.valid_len, batch.read_id, batch.start,
         batch.read_len), 4)
    table, bf, seed_fw, has_seed, ovf = JS.sharded_stage1(  # jitted
        jmesh, *arrays, JB.make_bloom(1 << 16, 4), k=25, short_k=21,
        cov_threshold=2, num_reads=batch.num_reads, add_to_bloom=True)
    size = int(table.size)
    assert int(ovf) == 0
    for got in ranks["stage1"]:
        assert got["ovf"] == 0 and got["size"] == size > 0
        assert np.array_equal(got["keys"], _np(table.keys)[:size])
        assert np.array_equal(got["counts"], _np(table.counts)[:size])
        assert np.array_equal(got["bits"],
                              np.asarray(bf.bits).view(np.int32))
        assert np.array_equal(got["seed_fw"], _np(seed_fw))
        assert np.array_equal(got["has_seed"], np.asarray(has_seed))
    assert ranks["stage1"][0]["has_seed"].any()


@pytest.mark.parametrize("case", CASES)
def test_assemble_mesh_matches_jax(ranks, jmesh, case):
    """The single-shot GFA on four ranks equals the JAX package's on a
    4-device mesh and the port's on one device, on every rank: a random
    genome, a repeat genome, exact membership with the Bloom filter built
    anyway, and the reference's filter sizing in Bloom membership with a
    filter small enough that the closure adds nodes after sharded stage 1.
    """
    reads, kw = worker.assemble_cases()[case]
    j = j_assemble(reads, JConfig(log_path=None, **kw), write_output=False,
                   mesh=jmesh)
    t = t_assemble(reads, TConfig(log_path=None, **kw), write_output=False,
                   device="cpu")
    assert t.gfa_lines == j.gfa_lines
    for got in ranks[f"assemble_{case}"]:
        assert got["gfa"] == j.gfa_lines
        assert got["num_nodes"] == j.num_nodes
    assert t.num_straights >= 1
    if case == "reference_filter":
        stats = ranks[f"assemble_{case}"][0]["stats"]
        assert stats["closure_rounds"] >= 1
        assert stats["graph_nodes"] > stats["solid_nodes"]


def test_every_rank_returns_rank0s_result(ranks):
    for case in CASES:
        got = ranks[f"assemble_{case}"]
        assert all(r["gfa"] == got[0]["gfa"] and r["stats"] == got[0]["stats"]
                   for r in got)
        mesh = got[0]["stats"]["mesh"]
        assert mesh["backend"] == "gloo" and mesh["world_size"] == 4
        assert [r["rank"] for r in mesh["ranks"]] == [0, 1, 2, 3]
        assert all(r["traffic_bytes"]["stage1 short"] > 0
                   for r in mesh["ranks"])


def test_tiny_slack_raises_on_every_rank(ranks):
    errors = [r["error"] for r in ranks["tiny_slack"]]
    assert all(e is not None and SLACK_MESSAGE.fullmatch(e) for e in errors)
    assert len(set(errors)) == 1


def test_ablated_collectives_run(ranks):
    """The ablation (no exchange; results wrong by design) runs through;
    only shapes and liveness are checked, as in tests/test_sharded.py."""
    for got, full in zip(ranks["ablate"], ranks["stage1"]):
        assert got["size"] >= 1
        assert got["seed_fw"].shape == full["seed_fw"].shape
        assert got["bits"].shape == full["bits"].shape


def test_pad_batch_to_devices_matches_jax():
    batch = jreads.reads_from_strings(worker.stage1_reads(), 25, 256)
    arrays = (batch.packed, batch.valid_len, batch.read_id, batch.start,
              batch.read_len)
    for n in (3, 4, 8):
        for a, b in zip(JS.pad_batch_to_devices(arrays, n),
                        TS.pad_batch_to_devices(arrays, n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert a.shape[0] % n == 0


def test_mesh_of_one_rank_equals_single_device(monkeypatch):
    """``--mesh`` without a launcher's environment is a world of one rank:
    no process group, no collective, the single-device GFA."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = TS.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "none")
    assert not torch.distributed.is_initialized()
    reads, kw = worker.assemble_cases()["random"]
    single = t_assemble(reads, TConfig(log_path=None, **kw),
                        write_output=False, device="cpu")
    one = t_assemble(reads, TConfig(log_path=None, **kw),
                     write_output=False, mesh=mesh)
    assert one.gfa_lines == single.gfa_lines
    assert one.stats["mesh"]["ranks"][0]["traffic_bytes"] == {}


def test_backend_chosen_from_counts():
    """NCCL exactly when no two ranks share a card, whatever the hosts and
    whatever each process sees; gloo on the CPU."""
    assert TS.choose_backend([None] * 4) == "gloo"
    # four ranks on one card share it through gloo (NCCL refuses that)
    assert TS.choose_backend(["GPU-a"] * 4) == "gloo"
    assert TS.choose_backend(["GPU-a"]) == "nccl"
    # a card a rank, on one host or each rank seeing only its own card
    assert TS.choose_backend(["GPU-a", "GPU-b", "GPU-c", "GPU-d"]) == "nccl"
    # two hosts of four cards, with no local counts needed
    assert TS.choose_backend([f"GPU-{i}" for i in range(8)]) == "nccl"
    # two hosts whose four ranks each share one card
    assert TS.choose_backend(["GPU-a"] * 4 + ["GPU-b"] * 4) == "gloo"


def test_rank_device(monkeypatch):
    assert TS.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TS.rank_device("cuda", None) == torch.device("cuda", 0)
    assert TS.rank_device("cuda", 3) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TS.rank_device("cuda", 2) == torch.device("cuda", 2)
    assert TS.rank_device("cuda", 6) == torch.device("cuda", 2)
    with pytest.raises(RuntimeError, match="sees 4 cards"):
        TS.rank_device("cuda", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.rank_device("cuda", 0)


def test_rank0_failure_reaches_every_rank(ranks):
    """Rank 0 cannot write the GFA after the other ranks finished stage 1:
    they raise rank 0's error instead of waiting in a collective."""
    root, *others = [r["error"] for r in ranks["root_fails"]]
    assert root is not None and root.startswith("FileNotFoundError: ")
    assert others == [f"RuntimeError: rank 0 failed: {root}"] * 3


def test_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 4 ... --mesh
    --device cpu`` writes one GFA, equal to the single-device CLI's, and a
    log whose first line names the backend and every rank's device."""
    reads, _ = worker.assemble_cases()["repeat"]
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    args = ["-i", str(fasta), "-k", "25", "--chunk-len", "512",
            "--device", "cpu"]
    out, log = tmp_path / "mesh.gfa", tmp_path / "mesh.log"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(worker.REPO))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "platanus3_tpu_torch.cli", "--mesh",
         *args, "-o", str(out), "--log", str(log)],
        cwd=worker.REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.count("wrote ") == 1
    single = tmp_path / "single.gfa"
    assert t_cli.main(args + ["-o", str(single), "--log", ""]) == 0
    assert out.read_text() == single.read_text()
    first = log.read_text().splitlines()[0]
    assert first.endswith("mesh: backend gloo, 4 ranks, devices rank 0 cpu, "
                          "rank 1 cpu, rank 2 cpu, rank 3 cpu")
    assert sum("stats {" in ln for ln in log.read_text().splitlines()) == 1
