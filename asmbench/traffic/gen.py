"""Genomes and read sets from a seed: the one generator of every traffic mix.

A vectorised copy of ``platanus3_tpu_torch/sim.py``'s generators, with
the same distributions:

* a genome is uniform random bases, or ``realistic``: GC-skewed bases
  with planted homopolymer runs, tandem repeats and dispersed repeat
  copies at the same rates per megabase as ``sim.realistic_genome``;
* a read starts uniformly on the genome, so that it ends on it, then
  each base is substituted by one of the three others with probability
  ``sub_rate``, deleted with ``del_rate``, and followed by an inserted
  random base with ``ins_rate``; half of the reads, drawn at random, are
  reverse-complemented.

Where ``sim.py`` gives every read one length, the lengths here are drawn
from a log-normal of mean ``read_len`` and standard deviation
``read_len_sd`` (one length where it is 0), clipped to
``[min_read_len, genome length]``.  They come from the mix's own
``lengths_salt`` and the genome's seed, never from the run's seed, so
that every seed reads the same set of lengths, in another order.

Where ``sim.py`` draws one uniform number per base, this module draws the
gaps between error positions from the geometric distribution, which
gives the same Bernoulli process in far fewer draws.  Reads are made in
blocks, so a chromosome-sized read set never holds a per-base index.

A read set is ``(codes, offs)``: every read's base codes (A, C, G, T =
0..3) concatenated into one ``uint8`` array, and ``offs[i]:offs[i+1]``
the span of read ``i``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_rng", "make_genome", "simulate_reads", "write_fasta",
           "num_reads", "read_lengths"]

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_READ_BLOCK = 2048


def make_rng(seed: int, salt: int) -> np.random.Generator:
    """The generator of one stream of a run (``salt`` names the stream)."""
    return np.random.default_rng([int(salt), int(seed) % (1 << 64)])


def _gc_skewed(length: int, gc: float, rng) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=length, p=p).astype(np.uint8)


def _plant_homopolymers(g, n_runs, rng, min_len=8, max_len=30):
    lens = rng.integers(min_len, max_len + 1, size=n_runs)
    for run_len in lens:
        p = int(rng.integers(0, max(1, len(g) - run_len)))
        g[p:p + run_len] = rng.integers(0, 4)


def _plant_tandem_repeats(g, n_loci, rng, unit_min=2, unit_max=12,
                          copies_min=4, copies_max=40):
    for _ in range(n_loci):
        unit_len = int(rng.integers(unit_min, unit_max + 1))
        copies = int(rng.integers(copies_min, copies_max + 1))
        tract = np.tile(rng.integers(0, 4, size=unit_len, dtype=np.uint8),
                        copies)
        p = int(rng.integers(0, max(1, len(g) - tract.shape[0])))
        g[p:p + tract.shape[0]] = tract


def _plant_repeats(g, repeat_len, n_copies, rng):
    rep = rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
    gap = 2 * repeat_len
    cand = np.arange(gap, len(g) - repeat_len - gap, gap)
    pos = rng.choice(cand, size=min(n_copies, cand.shape[0]), replace=False)
    for p in pos:
        g[p:p + repeat_len] = rep


def make_genome(spec: dict, rng) -> np.ndarray:
    """A genome's base codes from its spec: ``kind`` ``random`` or
    ``realistic`` (with ``gc`` and optional per-megabase rates)."""
    length = int(spec["length"])
    if spec["kind"] == "random":
        return rng.integers(0, 4, size=length, dtype=np.uint8)
    if spec["kind"] != "realistic":
        raise ValueError(f"unknown genome kind {spec['kind']!r}")
    mb = length / 1e6
    g = _gc_skewed(length, float(spec.get("gc", 0.6)), rng)
    _plant_homopolymers(g, max(1, int(spec.get("homopolymers_per_mb", 300)
                                      * mb)), rng)
    _plant_tandem_repeats(g, max(1, int(spec.get("tandems_per_mb", 150)
                                        * mb)), rng)
    rep_len = int(spec.get("dispersed_repeat_len", 200))
    per_mb = int(spec.get("dispersed_per_mb", 100))
    if per_mb > 0 and length > 4 * rep_len:
        _plant_repeats(g, rep_len, max(1, int(per_mb * mb)), rng)
    return g


def num_reads(genome_len: int, coverage: float, read_len: int) -> int:
    return max(1, int(genome_len * coverage / read_len))


def read_lengths(genome_len: int, traffic: dict, rng) -> np.ndarray:
    """The mix's read lengths, in the order ``rng`` draws them."""
    mean = int(traffic["read_len"])
    n = num_reads(genome_len, float(traffic["coverage"]), mean)
    sigma2 = np.log1p((float(traffic["read_len_sd"]) / mean) ** 2)
    lens = rng.lognormal(np.log(mean) - sigma2 / 2, np.sqrt(sigma2), size=n)
    return np.clip(np.rint(lens).astype(np.int64),
                   min(int(traffic["min_read_len"]), genome_len),
                   genome_len)


def _bernoulli_positions(n: int, p: float, rng) -> np.ndarray:
    """Sorted indices in ``[0, n)`` where a Bernoulli(p) trial succeeds."""
    if p <= 0 or n == 0:
        return np.zeros(0, dtype=np.int64)
    mean = n * p
    parts, last = [], -1
    while True:
        gaps = rng.geometric(p, size=int(mean + 6 * np.sqrt(mean) + 64))
        pos = last + np.cumsum(gaps)
        parts.append(pos)
        last = int(pos[-1])
        if last >= n:
            break
    pos = np.concatenate(parts)
    return pos[pos < n]


def _per_read(pos: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """How many of the positions ``pos`` fall in each read."""
    rid = np.searchsorted(offs, pos, side="right") - 1
    return np.bincount(rid, minlength=offs.shape[0] - 1)


def _read_block(g, starts, lens, flip, traffic, rng):
    offs = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = np.concatenate([g[a:a + n] for a, n in zip(starts.tolist(),
                                                      lens.tolist())])
    sub = _bernoulli_positions(flat.shape[0], traffic.get("sub_rate", 0.0),
                               rng)
    flat[sub] = (flat[sub] + rng.integers(1, 4, size=sub.shape[0])) % 4
    dele = _bernoulli_positions(flat.shape[0], traffic.get("del_rate", 0.0),
                                rng)
    if dele.shape[0]:
        flat = np.delete(flat, dele)
        lens = lens - _per_read(dele, offs)
        offs[1:] = np.cumsum(lens)
    ins = _bernoulli_positions(flat.shape[0], traffic.get("ins_rate", 0.0),
                               rng)
    if ins.shape[0]:    # a random base after each base at ``ins``
        flat = np.insert(flat, ins + 1, rng.integers(
            0, 4, size=ins.shape[0], dtype=np.uint8))
        lens = lens + _per_read(ins, offs)
        offs[1:] = np.cumsum(lens)
    for i in np.flatnonzero(flip).tolist():
        a, b = offs[i], offs[i + 1]
        flat[a:b] = 3 - flat[a:b][::-1]
    return flat, lens


def simulate_reads(genome: np.ndarray, traffic: dict, rng, lengths_rng):
    """The traffic mix's read set on ``genome``: ``(codes, offs)``.  The
    lengths come from ``lengths_rng`` and are shuffled, placed and
    sequenced by ``rng``."""
    read_len = rng.permutation(read_lengths(genome.shape[0], traffic,
                                            lengths_rng))
    n = read_len.shape[0]
    starts = rng.integers(0, genome.shape[0] - read_len + 1)
    flip = rng.random(n) < 0.5
    codes, lens = [], []
    for lo in range(0, n, _READ_BLOCK):
        hi = min(n, lo + _READ_BLOCK)
        c, l = _read_block(genome, starts[lo:hi], read_len[lo:hi],
                           flip[lo:hi], traffic, rng)
        codes.append(c)
        lens.append(l)
    lens = np.concatenate(lens)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return np.concatenate(codes), offs


def write_fasta(path, codes: np.ndarray, offs: np.ndarray) -> None:
    """Write the read set as FASTA, one line a read, named ``r<i>``."""
    with open(path, "wb") as f:
        for lo in range(0, offs.shape[0] - 1, _READ_BLOCK):
            hi = min(offs.shape[0] - 1, lo + _READ_BLOCK)
            text = _ASCII[codes[offs[lo]:offs[hi]]].tobytes()
            base = offs[lo]
            f.write(b"".join(
                b">r%d\n%s\n" % (i, text[offs[i] - base:offs[i + 1] - base])
                for i in range(lo, hi)))
