"""Streaming in Bloom membership, port against the JAX package, exact.

A filter small enough for false positives (2^15 bits, 2 hashes, on about
4,000 solid k-mers): the GFA must be equal line for line, and so must the
state both packages checkpoint after pass 2 (``spass2``): the node table,
the seeds and the Bloom words.  The port's words are int32 bit patterns
of the JAX package's uint32 words.
"""

from pathlib import Path

import numpy as np
import pytest

from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.streaming import assemble_streaming as j_streaming
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.streaming import assemble_streaming as t_streaming

CFG = dict(k=25, chunk_len=256, use_exact_membership=False,
           filter_bits=1 << 15, num_hashes=2, log_path=None)


def reads():
    genome = "".join(np.random.default_rng(83).choice(list("ACGT"),
                                                       size=4000))
    return [genome[s:s + 300] for s in range(0, len(genome) - 300 + 1, 60)]


def spass2(ckpt_dir: Path) -> dict:
    (path,) = ckpt_dir.glob("*/spass2.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("bloom_streaming")
    rs = reads()
    j = j_streaming(rs, JConfig(checkpoint_dir=str(base / "j"), **CFG),
                    write_output=False, slice_chunks=8)
    t = t_streaming(rs, TConfig(checkpoint_dir=str(base / "t"), **CFG),
                    write_output=False, slice_chunks=8, device="cpu")
    return j, t, spass2(base / "j"), spass2(base / "t")


def test_bloom_streaming_gfa_identical(runs):
    j, t, _, _ = runs
    assert t.gfa_lines == j.gfa_lines
    assert t.num_nodes == j.num_nodes
    # False positives: present neighbours that are not nodes (streaming
    # runs no closure, so they stay absent from the table).
    dbg = t.dbg
    assert bool(((dbg.left_present & (dbg.left_id < 0))
                 | (dbg.right_present & (dbg.right_id < 0))).any())


def test_bloom_streaming_pass2_state_identical(runs):
    _, _, jd, td = runs
    assert np.array_equal(td["bf_bits"].view(np.uint32), jd["bf_bits"])
    assert int(np.count_nonzero(td["bf_bits"])) > 0
    assert int(td["size"]) == int(jd["size"])
    assert np.array_equal(td["keys"], jd["keys"].astype(np.int64))
    for f in ("seed_fw", "min_pos", "has_seed"):
        assert np.array_equal(td[f], jd[f].astype(td[f].dtype)), f


def test_bloom_streaming_slice_invariant(runs):
    j, _, _, _ = runs
    t = t_streaming(reads(), TConfig(**CFG), write_output=False,
                    slice_chunks=16, device="cpu")
    assert t.gfa_lines == j.gfa_lines
