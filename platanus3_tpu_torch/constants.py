"""Global encoding constants.

TPU-native equivalent of the reference's global tables (reference:
``src/common.h:31-33``): 2-bit base code A=0, C=1, G=2, T=3, complement
A<->T, C<->G.  The complement of a 2-bit code ``b`` is ``3 - b`` which is
bitwise NOT within the 2-bit field -- the bit trick every kernel here relies
on (same trick the reference uses in ``src/BitCalc.cpp:35-45``).
"""

BASES = "ACGT"

BASE_TO_BIT = {"A": 0, "C": 1, "G": 2, "T": 3}

BIT_TO_BASE = {0: "A", 1: "C", 2: "G", 3: "T"}

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}

# 2-bit codes per uint32 lane.
BASES_PER_LANE = 16


def num_lanes(k: int) -> int:
    """Number of uint32 lanes needed to hold a k-mer (2 bits/base)."""
    return (k + BASES_PER_LANE - 1) // BASES_PER_LANE


def revcomp_str(s: str) -> str:
    """Reverse complement of a base string (host-side helper)."""
    return "".join(COMPLEMENT[c] for c in reversed(s))


def canonical_str(s: str) -> str:
    """Canonical form = lexicographic min of a k-mer and its reverse
    complement, forward wins ties (reference: ``src/BitCalc.cpp:47-54``,
    MSB-first bitset compare == lexicographic string compare for the
    A<C<G<T code)."""
    rc = revcomp_str(s)
    return s if s <= rc else rc
