"""Checkpoints in the port: round trips and crash-and-resume, for
``pipeline.assemble`` (stages 1, 2, 3) and for streaming (``spass2``,
``stage3``), on the inputs of ``tests/test_checkpoint.py``.  A resumed
run's GFA must equal an uncrashed run's, and the JAX package's.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch import pipeline as t_pipeline
from platanus3_tpu_torch import streaming as t_streaming_mod
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.ops import partitioned as t_part

ROOT = Path(__file__).resolve().parents[1]
BASES = "ACGT"


def tiled(seed, n, read_len, last, step):
    genome = "".join(np.random.default_rng(seed).choice(list(BASES), size=n))
    return [genome[s:s + read_len] for s in range(0, last + 1, step)]


def stage_files(ckpt_dir: Path) -> set:
    (digest,) = [d for d in ckpt_dir.iterdir() if d.is_dir()]
    return {p.name for p in digest.iterdir()}


def boom(*a, **kw):
    raise AssertionError("a stage re-ran despite its checkpoint")


def test_assemble_checkpoint_roundtrip(tmp_path, monkeypatch):
    reads = tiled(53, 1500, 200, 1300, 40)
    cfg = TConfig(k=25, chunk_len=256, log_path=None,
                  checkpoint_dir=str(tmp_path))
    r1 = t_pipeline.assemble(reads, cfg, write_output=False, device="cpu")
    assert {"stage1.npz", "stage2.npz", "stage3.npz"} <= stage_files(
        tmp_path)
    j = j_assemble(reads, JConfig(k=25, chunk_len=256, log_path=None),
                   write_output=False)
    assert r1.gfa_lines == j.gfa_lines

    # Full resume: stages 1, 2 and 3 do not run.
    monkeypatch.setattr(t_pipeline, "_stage1", boom)
    monkeypatch.setattr(t_pipeline, "run_stage2", boom)
    monkeypatch.setattr(t_pipeline, "_stage3", boom)
    r2 = t_pipeline.assemble(reads, cfg, write_output=False, device="cpu")
    assert r2.gfa_lines == r1.gfa_lines

    # Without stage 3: the graph comes from stage 2, coverage runs again.
    monkeypatch.undo()
    (digest,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    (digest / "stage3.npz").unlink()
    monkeypatch.setattr(t_pipeline, "run_stage2", boom)
    r3 = t_pipeline.assemble(reads, cfg, write_output=False, device="cpu")
    assert r3.gfa_lines == r1.gfa_lines

    # Another configuration does not reuse the checkpoint.
    monkeypatch.undo()
    r4 = t_pipeline.assemble(reads, TConfig(k=27, chunk_len=256,
                                            log_path=None,
                                            checkpoint_dir=str(tmp_path)),
                             write_output=False, device="cpu")
    assert len([d for d in tmp_path.iterdir() if d.is_dir()]) == 2
    assert r4.gfa_lines != r1.gfa_lines or r4.num_nodes != r1.num_nodes


def test_streaming_checkpoint_roundtrip(tmp_path, monkeypatch):
    reads = tiled(53, 2500, 300, 2200, 50)
    cfg = TConfig(k=25, chunk_len=256, log_path=None, clip_tips=True,
                  checkpoint_dir=str(tmp_path))
    r1 = t_streaming_mod.assemble_streaming(reads, cfg, write_output=False,
                                            slice_chunks=8, device="cpu")
    assert {"spass2.npz", "stage3.npz"} <= stage_files(tmp_path)

    # Full resume: neither pass runs.
    monkeypatch.setattr(t_part, "collect_short_slice", boom)
    monkeypatch.setattr(t_part, "solid_collect_slice", boom)
    r2 = t_streaming_mod.assemble_streaming(reads, cfg, write_output=False,
                                            slice_chunks=8, device="cpu")
    assert r2.gfa_lines == r1.gfa_lines

    # Without stage 3: the graph and coverage come again from spass2.
    (digest,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    (digest / "stage3.npz").unlink()
    r3 = t_streaming_mod.assemble_streaming(reads, cfg, write_output=False,
                                            slice_chunks=16, device="cpu")
    assert r3.gfa_lines == r1.gfa_lines
    monkeypatch.undo()
    shot = t_pipeline.assemble(reads, TConfig(k=25, chunk_len=256,
                                              clip_tips=True, log_path=None),
                               write_output=False, device="cpu")
    assert shot.gfa_lines == r1.gfa_lines


_WORKER = """
import sys
import numpy as np
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.pipeline import assemble
from platanus3_tpu_torch.streaming import assemble_streaming
genome = "".join(np.random.default_rng(int(sys.argv[3])).choice(
    list("ACGT"), size=int(sys.argv[4])))
reads = [genome[s:s + 250] for s in range(0, len(genome) - 249, 50)]
cfg = AssemblyConfig(k=25, chunk_len=256, log_path=None,
                     use_exact_membership=sys.argv[5] == "exact",
                     filter_bits=1 << 16, checkpoint_dir=sys.argv[1])
if sys.argv[2] == "streaming":
    res = assemble_streaming(reads, cfg, write_output=False,
                             slice_chunks=8, device="cpu")
else:
    res = assemble(reads, cfg, write_output=False, device="cpu")
sys.stdout.write("\\n".join(res.gfa_lines))
"""


@pytest.mark.parametrize("entry,faults,seed,size,membership", [
    ("assemble", ("stage1", "stage2"), 53, 1500, "exact"),
    ("streaming", ("spass2",), 59, 2000, "bloom"),
])
def test_crash_and_resume(tmp_path, entry, faults, seed, size, membership):
    """The worker process is killed (exit code 137) right after each
    checkpoint in ``faults`` lands; each restart resumes from what
    survived, and the last one's GFA equals an uncrashed run's."""
    env = dict(os.environ)
    env.pop("P3_FAULT_AFTER", None)

    def run(fault=None):
        e = dict(env, **({"P3_FAULT_AFTER": fault} if fault else {}))
        return subprocess.run(
            [sys.executable, "-c", _WORKER, str(tmp_path), entry, str(seed),
             str(size), membership],
            capture_output=True, text=True, env=e, timeout=600, cwd=ROOT)

    for fault in faults:
        r = run(fault)
        assert r.returncode == 137, r.stderr[-2000:]
        assert f"{fault}.npz" in stage_files(tmp_path)
    r = run()
    assert r.returncode == 0, r.stderr[-2000:]
    for d in tmp_path.iterdir():
        shutil.rmtree(d)
    fresh = run()
    assert fresh.returncode == 0, fresh.stderr[-2000:]
    assert r.stdout == fresh.stdout and r.stdout.count("\n") > 2
