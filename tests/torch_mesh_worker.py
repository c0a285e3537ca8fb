"""One rank of a ``platanus3_tpu_torch`` mesh run on the CPU (gloo), for
the ``tests/test_torch_sharded.py``, ``test_torch_streaming_mesh.py`` and
``test_torch_multihost.py`` tests.

    python tests/torch_mesh_worker.py OUT_DIR SCENARIO [SCENARIO ...]

with the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); ``launch`` starts the ranks
as subprocesses with a timeout.  Each scenario writes
``OUT_DIR/SCENARIO.rankR.pkl``.  A scenario whose name starts with
``init_`` joins the process group itself through ``multihost.initialize``
with explicit coordinator arguments (``P3_COORDINATOR``).

This module imports the port, torch and numpy, never JAX: the tests run
the JAX side in their own process, on inputs built by the functions below.
"""

from __future__ import annotations

import math
import os
import pickle
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT_DIR = Path(".")          # set by main: where the scenarios write
BASES = "ACGT"


# ---------------------------------------------------------------------------
# Inputs shared with the tests (numpy only).

def rand_genome(n: int, rng) -> str:
    return "".join(rng.choice(list(BASES), size=n))


def tiled(genome: str, read_len: int, step: int) -> list:
    return [genome[s:s + read_len]
            for s in range(0, len(genome) - read_len + 1, step)]


def repeat_genome(seed: int, unit: int = 600) -> str:
    rng = np.random.default_rng(seed)
    rep = rand_genome(120, rng)
    return (rand_genome(unit, rng) + rep + rand_genome(unit, rng) + rep
            + rand_genome(unit, rng))


def assemble_cases() -> dict:
    """name -> (reads, config keywords) of the single-shot mesh runs."""
    rng = np.random.default_rng(23)
    random_reads = tiled(rand_genome(3000, rng), 200, 40)
    noisy_rng = np.random.default_rng(29)
    genome = rand_genome(2500, noisy_rng)
    noisy = []
    for s in range(0, len(genome) - 250 + 1, 25):
        read = list(genome[s:s + 250])
        for i in np.flatnonzero(noisy_rng.random(250) < 0.01):
            read[i] = BASES[(BASES.index(read[i]) + 1) % 4]
        noisy.append("".join(read))
    return {
        "random": (random_reads, dict(k=25, chunk_len=256)),
        "repeat": (tiled(repeat_genome(31), 180, 35),
                   dict(k=25, chunk_len=512)),
        "exact_build_bloom": (random_reads,
                              dict(k=25, chunk_len=256, build_bloom=True)),
        # The reference's sizing at a low error rate: a filter so small
        # that the false-positive closure adds nodes.
        "reference_filter": (noisy, dict(k=25, chunk_len=256,
                                         use_exact_membership=False,
                                         filter_policy="reference",
                                         error_rate=0.002)),
    }


def stage1_reads() -> list:
    rng = np.random.default_rng(37)
    return tiled(rand_genome(2000, rng), 200, 40)


def route_inputs(rows: int = 3000, pool: int = 500, k: int = 25):
    """Random k-mer rows drawn from a pool (so counts exceed one), with
    valid and contributing masks: ``(strings, valid, contrib)``."""
    rng = np.random.default_rng(41)
    kmers = ["".join(rng.choice(list(BASES), size=k)) for _ in range(pool)]
    pick = rng.integers(0, pool, size=rows)
    valid = rng.random(rows) < 0.8
    contrib = valid & (rng.random(rows) < 0.7)
    return [kmers[i] for i in pick], valid, contrib


def or_words(rank: int, words: int = 1001) -> np.ndarray:
    rng = np.random.default_rng(100 + rank)
    return rng.integers(-2**31, 2**31, size=words).astype(np.int32)


def streaming_cases() -> dict:
    """name -> (reads, config keywords, slice_chunks) of the streaming
    mesh runs: the inputs of ``tests/test_streaming.py``'s mesh tests."""
    random_reads = tiled(rand_genome(3000, np.random.default_rng(91)), 300,
                         60)
    return {
        "stream_random": (random_reads, dict(k=25, chunk_len=256), 16),
        "stream_repeat_simplify": (
            tiled(repeat_genome(93), 180, 35),
            dict(k=25, chunk_len=512, clip_tips=True, pop_bubbles=True), 8),
        "stream_bloom": (random_reads,
                         dict(k=25, chunk_len=256, use_exact_membership=False,
                              filter_bits=1 << 14, num_hashes=2), 16),
    }


def multik_case():
    """Reads and config keywords of the multi-k mesh runs."""
    reads, kw, _ = streaming_cases()["stream_random"]
    return reads, dict(kw, k=25, k_list=(25, 33), clip_tips=True)


# ---------------------------------------------------------------------------
# Launch.

def free_port() -> int:
    """A free port below Linux's ephemeral range (32768 up).  A port the
    kernel hands out for ``bind(0)`` can be taken, between this check and
    rank 0's bind, as the ephemeral port of another launch's gloo
    connection; then ranks of two meshes talk to each other and abort.
    Ports below that range are never handed out that way."""
    rng = random.Random(os.getpid() ^ time.time_ns())
    while True:
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port


def rank_env(rank: int, nproc: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc),
                MASTER_ADDR="localhost", MASTER_PORT=str(port),
                OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))


def launch(out_dir, scenarios, nproc: int = 4, timeout: float = 300,
           device: str = "cpu"):
    """Run ``scenarios`` in ``nproc`` rank processes on ``device``; returns
    ``{scenario: [result of rank 0, ...]}``.  Every rank is killed after
    ``timeout`` seconds, so a hang fails instead of waiting forever."""
    out_dir = Path(out_dir)
    port = free_port()
    procs = []
    for r in range(nproc):
        env = rank_env(r, nproc, port)
        env["P3_COORDINATOR"] = f"localhost:{port}"
        env["P3_MESH_DEVICE"] = device
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out_dir), *scenarios], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n" \
                                  f"{out[-4000:]}"
    return {s: [pickle.loads((out_dir / f"{s}.rank{r}.pkl").read_bytes())
                for r in range(nproc)] for s in scenarios}


# ---------------------------------------------------------------------------
# Scenarios (run in the rank processes).

def _np(t):
    return t.cpu().numpy()


def _config(**kw):
    from platanus3_tpu_torch.config import AssemblyConfig
    kw.setdefault("log_path", None)
    return AssemblyConfig(**kw)


def _result(res) -> dict:
    from platanus3_tpu_torch.ops import bloom
    return {"gfa": res.gfa_lines, "num_nodes": res.num_nodes,
            "num_straights": res.num_straights, "stats": res.stats,
            "bloom_set_bits_launches": bloom.bloom_add.kernel_launches}


def run_or_allreduce(mesh):
    import torch
    from platanus3_tpu_torch.parallel import sharded
    got = sharded.or_allreduce(mesh, torch.from_numpy(or_words(mesh.rank)))
    return {"words": _np(got)}


def run_route(mesh):
    import torch
    from platanus3_tpu_torch.ops import count as count_mod
    from platanus3_tpu_torch.ops import kmer as kmer_mod
    from platanus3_tpu_torch.parallel import sharded
    strings, valid, contrib = route_inputs()
    per = len(strings) // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    kmers = torch.from_numpy(kmer_mod.encode_kmers_np(strings[lo:hi])
                             .astype(np.int64))
    cap = int(math.ceil(1.5 * per / mesh.size))
    routed = sharded.route_to_owners(
        mesh, kmers, torch.from_numpy(valid[lo:hi]),
        torch.from_numpy(contrib[lo:hi]), cap, 25)
    table, r_counts = count_mod.count_with_positions(
        routed.recv_kmers, routed.recv_flags > 0, routed.recv_flags == 2,
        k=25)
    per_pos = sharded.route_values_back(routed, r_counts, hi - lo)
    size = int(table.size)
    return {"per_pos": _np(per_pos), "overflow": int(routed.overflow),
            "keys": _np(table.keys[:size]), "counts": _np(table.counts[:size])}


def _stage1(mesh, **kw):
    from platanus3_tpu_torch.io import reads as reads_mod
    from platanus3_tpu_torch.ops import bloom as bloom_mod
    from platanus3_tpu_torch.parallel import sharded
    batch = reads_mod.reads_from_strings(stage1_reads(), 25, 256)
    arrays = sharded.pad_batch_to_devices(
        (batch.packed, batch.valid_len, batch.read_id, batch.start,
         batch.read_len), mesh.size)
    bf = bloom_mod.make_bloom(1 << 16, 4)
    table, bf, seed_fw, has_seed, ovf = sharded.sharded_stage1(
        mesh, *arrays, bf, k=25, short_k=21, cov_threshold=2,
        num_reads=batch.num_reads, **kw)
    size = int(table.size)
    return {"keys": _np(table.keys[:size]), "counts": _np(table.counts[:size]),
            "size": size, "bits": _np(bf.bits), "seed_fw": _np(seed_fw),
            "has_seed": _np(has_seed), "ovf": ovf}


def run_stage1(mesh):
    return _stage1(mesh, add_to_bloom=True)


def run_ablate(mesh):
    return _stage1(mesh, add_to_bloom=True, ablate_collectives=True)


def run_assemble(mesh, case):
    from platanus3_tpu_torch.pipeline import assemble
    reads, kw = assemble_cases()[case]
    return _result(assemble(reads, _config(**kw), write_output=False,
                            mesh=mesh))


def run_tiny_slack(mesh):
    from platanus3_tpu_torch.parallel import sharded
    from platanus3_tpu_torch.pipeline import assemble
    reads, kw = assemble_cases()["random"]
    defaults = sharded.sharded_stage1.__kwdefaults__
    slack, defaults["slack"] = defaults["slack"], 0.05
    try:
        assemble(reads, _config(**kw), write_output=False, mesh=mesh)
    except RuntimeError as e:
        return {"error": str(e)}
    finally:
        defaults["slack"] = slack
    return {"error": None}


def run_streaming(mesh, case, **extra):
    from platanus3_tpu_torch.streaming import assemble_streaming
    reads, kw, slice_chunks = streaming_cases()[case]
    return _result(assemble_streaming(reads, _config(**kw),
                                      write_output=False,
                                      slice_chunks=slice_chunks, mesh=mesh,
                                      **extra))


def run_stream_restore(mesh):
    """The repeat case with checkpoints, three times over one directory:
    a fresh run (saves ``spass2`` and ``stage3``), a run after rank 0
    deleted ``stage3`` (restores ``spass2``: passes 1 and 2 skipped on
    every rank, coverage still sharded), and a run restoring ``stage3``."""
    from platanus3_tpu_torch.streaming import assemble_streaming
    reads, kw, slice_chunks = streaming_cases()["stream_repeat_simplify"]
    ckpt = OUT_DIR / "ckpt"
    out = {"gfa": [], "stages": []}
    for step in ("fresh", "spass2", "stage3"):
        if step == "spass2" and mesh.is_root:
            for f in ckpt.glob("*/stage3.npz"):
                f.unlink()
        res = assemble_streaming(
            reads, _config(checkpoint_dir=str(ckpt), **kw),
            write_output=False, slice_chunks=slice_chunks, mesh=mesh)
        out["gfa"].append(res.gfa_lines)
        out["stages"].append(sorted(res.stats["stages"]))
    return out


def run_tiny_short_cap(mesh):
    try:
        run_streaming(mesh, "stream_random", short_cap=64)
    except RuntimeError as e:
        return {"error": str(e)}
    return {"error": None}


def run_multik(mesh):
    from platanus3_tpu_torch.graph.multik import assemble_multik
    reads, kw = multik_case()
    return _result(assemble_multik(reads, _config(**kw), write_output=False,
                                   mesh=mesh))


def run_multik_streaming(mesh):
    from platanus3_tpu_torch.graph.multik import assemble_multik
    reads, kw = multik_case()
    return _result(assemble_multik(reads, _config(**kw), write_output=False,
                                   mesh=mesh, streaming=True,
                                   slice_chunks=16))


def run_root_fails(mesh, streaming: bool = False):
    """A run whose GFA rank 0 cannot write (its directory does not exist):
    rank 0 raises while the other ranks wait for its result, and they must
    raise too instead of waiting.  Returns each rank's error."""
    from platanus3_tpu_torch.pipeline import assemble
    from platanus3_tpu_torch.streaming import assemble_streaming
    reads, kw = assemble_cases()["random"]
    cfg = _config(gfa_path=str(OUT_DIR / "missing" / "out.gfa"), **kw)
    try:
        if streaming:
            assemble_streaming(reads, cfg, slice_chunks=16, mesh=mesh)
        else:
            assemble(reads, cfg, mesh=mesh)
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {"error": None}


def run_init_explicit(_mesh):
    """multihost.initialize with explicit coordinator arguments, then
    gather_to_host0 of rank-dependent arrays and a host_local_batch."""
    import torch
    import torch.distributed as dist
    from platanus3_tpu_torch.io import reads as reads_mod
    from platanus3_tpu_torch.parallel import multihost
    multihost.initialize(os.environ["P3_COORDINATOR"],
                         int(os.environ["WORLD_SIZE"]),
                         int(os.environ["RANK"]), device="cpu")
    mesh = multihost.global_mesh("cpu")
    gathered = multihost.gather_to_host0(
        {"np": np.full((3,), mesh.rank, np.int32),
         "t": torch.full((2, 2), mesh.rank, dtype=torch.int64)})
    batch = reads_mod.reads_from_strings(stage1_reads(), 25, 256)
    local = multihost.host_local_batch(batch)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "devices": mesh.devices, "np": gathered["np"],
           "t": _np(gathered["t"]), "packed": local.packed,
           "read_id": local.read_id}
    dist.destroy_process_group()
    return out


SCENARIOS = {
    "or_allreduce": run_or_allreduce,
    "route": run_route,
    "stage1": run_stage1,
    "ablate": run_ablate,
    "tiny_slack": run_tiny_slack,
    "tiny_short_cap": run_tiny_short_cap,
    "multik": run_multik,
    "multik_streaming": run_multik_streaming,
    "stream_restore": run_stream_restore,
    "root_fails": run_root_fails,
    "stream_root_fails": lambda m: run_root_fails(m, streaming=True),
    "init_explicit": run_init_explicit,
    **{f"assemble_{c}": (lambda m, c=c: run_assemble(m, c))
       for c in ("random", "repeat", "exact_build_bloom",
                 "reference_filter")},
    **{c: (lambda m, c=c: run_streaming(m, c))
       for c in ("stream_random", "stream_repeat_simplify", "stream_bloom")},
}


def main(argv) -> int:
    global OUT_DIR
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(1)
    OUT_DIR, scenarios = Path(argv[0]), argv[1:]
    mesh = None
    if not all(s.startswith("init_") for s in scenarios):
        from platanus3_tpu_torch.parallel import sharded
        mesh = sharded.make_mesh(os.environ.get("P3_MESH_DEVICE", "cpu"))
    for s in scenarios:
        result = SCENARIOS[s](mesh)
        rank = int(os.environ["RANK"])
        (OUT_DIR / f"{s}.rank{rank}.pkl").write_bytes(pickle.dumps(result))
    # The ranks leave the group together, before the interpreter exits: a
    # rank whose gloo group is still open when it exits, while another is
    # still at work or already gone, can abort on the way out (SIGABRT,
    # "terminate called without an active exception"), which failed a
    # launch whose results were all written.
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
