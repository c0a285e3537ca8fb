"""Run one cell of the port's benchmark and print its result line.

    python3 -m asmbench.run --workload ecoli_k12.hifi20x --seed 7 \\
        --seconds 51 --trace 0

A run makes the cell's genome and reads from ``--seed``, writes them as a
FASTA under ``TMPDIR``, imports ``platanus3_tpu_torch``, builds its
kernels and read loader (into ``build/`` of the checkout) and runs one
cold job: ``cli.main`` on the FASTA with the configuration's arguments,
as a user would run it, with ``--trace 1`` too.  That ends the set-up
(``setup_s``, the cold job included; the cold job alone is the per-layer
``cold_job_s``).  The window then runs the same job back to back and
closes at the end of the first job that ends after ``--seconds``.  With
``--trace 1`` every window job adds ``--profile-stages``, and the jobs of
the window's first ten seconds (at least one) run under
``torch.profiler``.

Once the window has closed, the device memory peak has been read and the
program's state freed, the plain reference (``references/``) assembles
the same reads on the card, and every window job's GFA is compared with
it (``compare.py``).  The numbers compared go to standard error as its
last lines, and the last line of standard output is the result: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
(``metrics/<name>.py``) with ``--trace 1``.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits with 2 and prints no result; one that finds JAX or the JAX package
loaded once the window has closed, when it closes or when the result is
about to be printed, exits with 3 and prints no result.
"""

from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from asmbench import compare, spec, trace as trace_mod, yardstick  # noqa: E402
from asmbench.traffic import gen  # noqa: E402

__all__ = ["Job", "Run", "make_inputs", "run_window", "end_to_end",
           "run_cell", "report", "main", "forbidden_loaded",
           "FORBIDDEN_MODULES"]

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "platanus3_tpu")
TRACE_SECONDS = 10.0


class JaxLoaded(RuntimeError):
    pass


@dataclasses.dataclass
class Job:
    seconds: float
    ok: bool
    gfa: Path
    log: Path
    launches: int            # bloom_set_bits launches the job made
    stats: dict = None       # the job's ``stats`` log line


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    params: dict             # the configuration's parameters
    jobs: list               # the window's jobs
    traced: int              # how many of them, from the first, were traced
    trace: object            # trace.TraceSummary, or None
    ref: object              # the reference's Assembly
    chunks: int              # chunks the reads split into
    cold_s: float            # the cold job's seconds
    device_kind: str


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``), or since this
    module was imported where ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def make_inputs(cell: spec.Cell, seed: int):
    """The cell's read set ``(codes, offs)``: reads drawn from ``seed`` on
    the configuration's genome, which its own ``seed`` fixes (one genome
    a deployment; each run sequences it anew).  The set of read lengths
    is fixed by the genome's seed too, so that every seed does the same
    work; ``seed`` orders, places and sequences the reads."""
    spec_g, mix = cell.config["genome"], cell.traffic
    genome = gen.make_genome(spec_g, gen.make_rng(spec_g["seed"],
                                                  mix["genome_salt"]))
    return gen.simulate_reads(
        genome, mix, gen.make_rng(seed, mix["reads_salt"]),
        gen.make_rng(spec_g["seed"], mix["lengths_salt"]))


def forbidden_loaded(modules=None) -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name (``platanus3_tpu_torch`` is another name)."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def _stats(log: Path):
    """The ``stats`` line of a job's log, or None."""
    if not log.exists():
        return None
    for line in reversed(log.read_text().splitlines()):
        if "] stats {" in line:
            return json.loads(line.split("] stats ", 1)[1])
    return None


def run_window(run_job, seconds: float, jobs: list, t0: float,
               clock=time.perf_counter) -> float:
    """Run jobs back to back, appending each to ``jobs``, until one ends
    ``seconds`` or more after ``t0``, and at least one; returns the time
    from ``t0`` to the end of the last."""
    while True:
        jobs.append(run_job(len(jobs)))
        if clock() - t0 >= seconds:
            return clock() - t0


def end_to_end(bases: int, n_jobs: int, window_s: float, peak_bytes: int,
               setup_s: float) -> dict:
    """The end-to-end metrics of a run: every job's read bases over the
    whole window, the reserved peak and the set-up."""
    return {"asm_mbases_per_s": bases * n_jobs / window_s / 1e6,
            "peak_device_gb": peak_bytes / 1e9,
            "setup_s": setup_s}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", job=None, workdir: Path = None) -> dict:
    """One run of ``cell``; returns the result (``check`` last).  ``job``
    replaces ``cli.main`` (the tests break the timed path with it)."""
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    params = cell.config["params"]
    work = workdir or Path(tempfile.gettempdir()) / "asmbench" / cell.name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    marks = [("start", process_age_s())]
    codes, offs = make_inputs(cell, seed)
    marks.append(("inputs", process_age_s()))
    fasta = work / "reads.fasta"
    gen.write_fasta(fasta, codes, offs)
    marks.append(("fasta", process_age_s()))

    from platanus3_tpu_torch import cli, native
    from platanus3_tpu_torch.ops import bloom
    job = job or cli.main
    native.get_lib()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        from platanus3_tpu_torch import kernels
        kernels.load_library()
        torch.zeros(1, device=dev)
        sync()

    def run_job(name, profile=trace) -> Job:
        gfa, log = work / f"job{name}.gfa", work / f"job{name}.log"
        argv = ["-i", str(fasta), *cell.config["cli_args"], "-o", str(gfa),
                "--log", str(log), "--device", device]
        if profile:
            argv.append("--profile-stages")
        n0 = bloom.bloom_add.kernel_launches
        t = time.perf_counter()
        try:
            ok = job(argv) == 0
        except Exception:   # a failed job is counted, and the run goes on
            traceback.print_exc(file=sys.stderr)
            ok = False
        sync()
        return Job(time.perf_counter() - t, ok, gfa, log,
                   bloom.bloom_add.kernel_launches - n0)

    marks.append(("port", process_age_s()))
    cold = run_job("cold", profile=False)
    if not cold.ok:
        raise RuntimeError("the cold job failed")
    cold.gfa.unlink(missing_ok=True)
    cold.log.unlink(missing_ok=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_age_s()
    marks.append(("cold", setup_s))

    # ---- the window ----
    jobs, traced, trace_file = [], 0, work / "trace.json"
    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])

        def traced_job(i):
            with record_function(trace_mod.JOB):
                return run_job(i)

        with profile(activities=acts) as prof:
            # The window of a traced run starts once the profiler runs.
            t0 = time.perf_counter()
            with record_function(trace_mod.WINDOW):
                run_window(traced_job, min(TRACE_SECONDS, seconds), jobs, t0)
        traced = len(jobs)
    window_s = time.perf_counter() - t0
    if window_s < seconds:
        window_s = run_window(run_job, seconds, jobs, t0)
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    bad = forbidden_loaded()
    if bad:
        raise JaxLoaded(f"loaded once the window closed: {', '.join(bad)}")

    summary = None
    if trace:
        prof.export_chrome_trace(str(trace_file))
        del prof
        for j in jobs:
            j.stats = _stats(j.log)
        summary = trace_mod.summarize(
            trace_file, [(j.stats or {}).get("stages", {})
                         for j in jobs[:traced]])
        trace_file.unlink()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison ----
    answers = []
    for j in jobs:
        j.stats = j.stats or _stats(j.log)
        text = j.gfa.read_text() if j.ok and j.gfa.exists() else None
        answers.append((text, (j.stats or {}).get("solid_nodes")))
        j.gfa.unlink(missing_ok=True)
    ref_s = time.perf_counter()
    ref = cell.reference()(codes, offs, params, device=device)
    sync()
    ref_s = time.perf_counter() - ref_s
    checks = compare.checks(answers, ref)
    failed = sum(1 for j in jobs if not j.ok)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    bases = int(np.diff(offs)[np.diff(offs) >= params["k"]].sum())
    if trace:
        run = Run(params=params, jobs=jobs, traced=traced, trace=summary,
                  ref=ref, chunks=yardstick.num_chunks(offs, params["k"],
                                                       params["chunk_len"]),
                  cold_s=cold.seconds, device_kind=kind)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(bases, len(jobs), window_s, peak, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        top = sorted(summary.kernels.items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in top[:trace_mod.TOP]],
            "idle_gaps": [[n[:160], s] for n, s in summary.gaps]}
    print(f"asmbench: {cell.name} seed {seed}: {len(jobs)} jobs in "
          f"{window_s:.3f} s (each job, s: "
          f"{' '.join(f'{j.seconds:.3f}' for j in jobs)}), cold job "
          f"{cold.seconds:.3f} s, set-up "
          f"{setup_s:.3f} s, reference {ref.straights} straights, "
          f"{ref.junctions} junctions, {ref.links} links, "
          f"{ref.solid_nodes} solid nodes; set-up (s): imports "
          f"{marks[0][1]:.3f}, "
          + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                      for a, b in zip(marks, marks[1:]))
          + f"; reference {ref_s:.3f} s", file=sys.stderr)
    result["check"] = checks
    shutil.rmtree(work, ignore_errors=True)
    return result


def report(result: dict) -> int:
    """Print the numbers compared (standard error) and the result line
    (standard output), unless JAX or the JAX package has been loaded by
    now: then name it and return 3, printing no result."""
    bad = forbidden_loaded()
    if bad:
        print(f"asmbench: loaded once the window closed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="asmbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"asmbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except JaxLoaded as e:
        print(f"asmbench: {e}", file=sys.stderr)
        return 3
    return report(result)


if __name__ == "__main__":
    sys.exit(main())
