"""Core k-mer bit primitives on int64 lane tensors.

Port of ``platanus3_tpu/ops/kmer.py``.  A batch of k-mers is a tensor of
shape ``[..., L]`` with ``L = ceil(k/16)`` lanes: lane 0 holds the most
significant bits (the first bases), and the 2k-bit value is low-aligned
inside the 32*L-bit multiword.  Each lane is an ``int64`` holding a
``uint32`` value, so every shift or complement that can leave the low 32
bits is masked back with ``MASK32``.

With this layout a lexicographic compare over lanes 0..L-1 is the
reference's MSB-first ``CompareBit`` and reverse complement is bitwise
NOT plus a 2-bit-group reversal, exactly as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from platanus3_tpu_torch.constants import (BASES_PER_LANE, BASE_TO_BIT,
                                           num_lanes)

__all__ = [
    "MASK32",
    "num_lanes",
    "encode_kmers_np",
    "decode_kmers_np",
    "revcomp",
    "canonical",
    "lex_less",
    "lex_equal",
    "shift_in_right",
    "shift_in_left",
    "base_at",
    "first_base",
    "last_base",
    "is_palindrome",
    "extract_kmers",
    "pack_bases_np",
    "unpack_bases",
]

MASK32 = 0xFFFFFFFF


def _top_lane_bits(k: int) -> int:
    """Significant bits in lane 0 (the partial, most-significant lane)."""
    return 2 * k - 32 * (num_lanes(k) - 1)


def _top_mask(k: int) -> int:
    r = _top_lane_bits(k)
    return MASK32 if r >= 32 else (1 << r) - 1


# ---------------------------------------------------------------------------
# Host-side encode / decode (numpy; used for I/O, tests and GFA output)
# ---------------------------------------------------------------------------

def encode_kmers_np(strings) -> np.ndarray:
    """Encode equal-length k-mer strings to ``[N, L] uint32`` (first base
    in the most significant 2 bits, ``GetFirstKmerForward``)."""
    if isinstance(strings, str):
        strings = [strings]
    k = len(strings[0])
    l = num_lanes(k)
    out = np.zeros((len(strings), l), dtype=np.uint32)
    for i, s in enumerate(strings):
        assert len(s) == k, "all k-mers must have equal length"
        v = 0
        for c in s:
            v = (v << 2) | BASE_TO_BIT[c]
        for j in range(l - 1, -1, -1):
            out[i, j] = v & MASK32
            v >>= 32
    return out


_DECODE_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_kmers_np(kmers: np.ndarray, k: int):
    """Decode ``[N, L]`` lane values back to strings (``GetStringKmer``).

    Base ``i`` lives at bit offset ``q = 2*(k-1-i)`` of the low-aligned
    multiword: lane ``L-1 - q//32`` shifted by ``q%32``."""
    kmers = np.asarray(kmers).astype(np.uint32)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    n, l = kmers.shape
    q = 2 * (k - 1 - np.arange(k))
    lane = l - 1 - q // 32
    shift = (q % 32).astype(np.uint32)
    codes = (kmers[:, lane] >> shift[None, :]) & np.uint32(3)
    chars = _DECODE_ASCII[codes]
    return [row.tobytes().decode() for row in chars]


# ---------------------------------------------------------------------------
# Device-side primitives
# ---------------------------------------------------------------------------

def _reverse_pairs_u32(v: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit groups inside each 32-bit lane."""
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    return ((v << 16) | (v >> 16)) & MASK32


def revcomp(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers ``[..., L] -> [..., L]``
    (``GetComplementKmer``)."""
    l = num_lanes(k)
    assert kmers.shape[-1] == l
    top = kmers[..., :1] & _top_mask(k)
    comp = torch.cat([~top & _top_mask(k), ~kmers[..., 1:] & MASK32], dim=-1)
    # Reverse 2-bit groups within lanes, then the lane order: the value
    # is now HIGH-aligned in the multiword.
    rev = _reverse_pairs_u32(comp).flip(-1)
    # Re-align low: shift the whole multiword right by s = 32*L - 2k bits.
    s = 32 * l - 2 * k
    if s == 0:
        return rev
    hi = torch.cat([torch.zeros_like(rev[..., :1]),
                    (rev[..., :-1] << (32 - s)) & MASK32], dim=-1)
    return (rev >> s) | hi


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the lane axis (MSB lane first)."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for j in range(a.shape[-1]):
        aj, bj = a[..., j], b[..., j]
        less = less | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return less


def lex_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def canonical(kmers: torch.Tensor, k: int):
    """``(canon, is_fw)``: ``canon = min(kmer, revcomp(kmer))``, forward
    winning ties; ``is_fw`` is True where the forward form was kept."""
    rc = revcomp(kmers, k)
    rc_less = lex_less(rc, kmers)
    canon = torch.where(rc_less[..., None], rc, kmers)
    return canon, ~rc_less


def is_palindrome(kmers: torch.Tensor, k: int) -> torch.Tensor:
    return lex_equal(kmers, revcomp(kmers, k))


def _base_column(base, kmers: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(base, dtype=torch.int64,
                           device=kmers.device).expand(kmers.shape[:-1])


def shift_in_right(kmers: torch.Tensor, base, k: int) -> torch.Tensor:
    """Append ``base`` at the right end: ``(kmer << 2 | base) mod 4^k``
    (the reference's ``front_shifted_kmer``)."""
    hi = (kmers << 2) & MASK32
    lo = torch.cat([kmers[..., 1:] >> 30,
                    _base_column(base, kmers)[..., None]], dim=-1)
    out = hi | lo
    out[..., 0] &= _top_mask(k)
    return out


def shift_in_left(kmers: torch.Tensor, base, k: int) -> torch.Tensor:
    """Prepend ``base`` at the left end: ``(kmer >> 2) | base << (2k-2)``
    (the reference's ``back_shifted_kmer``)."""
    hi = torch.cat([torch.zeros_like(kmers[..., :1]),
                    (kmers[..., :-1] << 30) & MASK32], dim=-1)
    out = (kmers >> 2) | hi
    out[..., 0] |= _base_column(base, kmers) << (_top_lane_bits(k) - 2)
    return out


def base_at(kmers: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """2-bit code of base ``j`` (0 = leftmost) of packed k-mers."""
    q = 2 * (k - 1 - j)
    lane = num_lanes(k) - 1 - q // 32
    return (kmers[..., lane] >> (q % 32)) & 3


def first_base(kmers: torch.Tensor, k: int) -> torch.Tensor:
    return (kmers[..., 0] >> (_top_lane_bits(k) - 2)) & 3


def last_base(kmers: torch.Tensor, k: int) -> torch.Tensor:
    return kmers[..., -1] & 3


# ---------------------------------------------------------------------------
# Packed read storage and k-mer extraction
# ---------------------------------------------------------------------------

def pack_bases_np(bases: np.ndarray) -> np.ndarray:
    """Pack ``[C, N] uint8`` base codes into ``[C, N/16] uint32``, 16
    bases per lane, first base of each group most significant."""
    c, n = bases.shape
    assert n % BASES_PER_LANE == 0
    b = bases.astype(np.uint32).reshape(c, n // BASES_PER_LANE,
                                        BASES_PER_LANE)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    return (b << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)


def unpack_bases(packed: torch.Tensor) -> torch.Tensor:
    """``[C, W]`` lane values -> ``[C, W*16]`` int64 base codes (0..3)."""
    c, w = packed.shape
    shifts = torch.arange(30, -2, -2, dtype=torch.int64, device=packed.device)
    bases = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return bases.reshape(c, w * BASES_PER_LANE)


def sliding_words(bases: torch.Tensor) -> torch.Tensor:
    """``W16[c, p]`` = bases ``p..p+15`` of row ``c`` packed MSB-first,
    shape ``[C, N-15]``."""
    c, n = bases.shape
    p = n - (BASES_PER_LANE - 1)
    w = torch.zeros((c, p), dtype=torch.int64, device=bases.device)
    for t in range(BASES_PER_LANE):
        w |= bases[:, t:t + p] << (30 - 2 * t)
    return w


def extract_kmers(bases: torch.Tensor, lengths: torch.Tensor, k: int):
    """All forward k-mers of a base matrix, plus validity.

    ``bases [C, N]`` int64 codes, ``lengths [C]`` valid bases per row.
    Returns ``fw [C, P, L]`` (``P = N - k + 1``) and ``valid [C, P]``
    (position ``p`` valid iff ``p + k <= length``).
    """
    c, n = bases.shape
    l = num_lanes(k)
    p = n - k + 1
    assert p >= 1, f"chunk width {n} too small for k={k}"
    padded = torch.cat([bases, torch.zeros((c, BASES_PER_LANE),
                                           dtype=bases.dtype,
                                           device=bases.device)], dim=1)
    w16 = sliding_words(padded)
    r = k - 16 * (l - 1)  # bases in the partial top lane, 1..16
    top = w16[:, 0:p]
    if r < 16:
        top = top >> (32 - 2 * r)
    lanes = [top] + [w16[:, r + 16 * (j - 1):r + 16 * (j - 1) + p]
                     for j in range(1, l)]
    fw = torch.stack(lanes, dim=-1)
    pos = torch.arange(p, dtype=torch.int64, device=bases.device)[None, :]
    valid = pos + k <= lengths[:, None]
    return fw, valid
