"""Hash-prefix-sharded k-mer counting over ranks of ``torch.distributed``.

Port of ``platanus3_tpu/parallel/sharded.py``.  JAX runs one controller
over a mesh of devices (``shard_map`` over axis ``'d'``); here each rank
is a process with one device, runs the same per-shard function, and each
JAX collective becomes a collective of the process group:

* the chunked read batch is split data-parallel: rank r holds chunks
  ``[r*C/n, (r+1)*C/n)`` of the padded batch (``pad_batch_to_devices``),
  as ``shard_map`` splits it;
* each extracted canonical k-mer is routed to its owner rank ``h1 % n``
  (``route_to_owners``): one ``all_to_all_single`` of the bucket sizes,
  then one of the rows with those split sizes, so no padding row is sent.
  JAX's fixed bucket capacity ``cap = ceil(slack * N_local / n)`` stays a
  declared bound: rows above it are dropped and counted, as in JAX, and
  the count is summed over ranks before anyone raises, so every rank
  raises together and none waits in a collective.  The split sizes are
  read on the host: one device-to-host sync a route;
* per-position values ride the inverse exchange back
  (``route_values_back``);
* packed Bloom words are merged by ``or_allreduce``: NCCL has no bitwise-OR
  reduction, so an all-to-all of equal segments, a local OR and an
  all-gather, on both backends;
* ``pmin`` / ``pmax`` / ``psum`` become ``all_reduce`` MIN / MAX / SUM
  (seed lanes are int64 holding uint32 values, so MAX orders them as
  JAX's uint32 does);
* the shard tables are all-gathered and counted into one node table (JAX's
  replicated ``count_kmers`` with ``out_shardings=P()``).

Each rank's device is card ``local_rank % cards`` of the cards its
process sees (``rank_device``).  The backend is decided before
``init_process_group``, from the count of distinct cards among the ranks
(``choose_backend``): the ranks meet at the rendezvous store and post
their card's UUID there, so the rule holds across hosts and whatever
each process sees.  NCCL when no two ranks share a card, gloo on the CPU
and when ranks share a card (NCCL refuses two ranks on one device).
Gloo takes CUDA tensors for every collective used here, so the k-mer work
stays on the card either way.  A ``Mesh`` of one rank (``--mesh`` without
a launcher's environment) runs no collective at all.

While rank 0 works alone (stages 2-4, the streaming graph), the other
ranks wait for it in ``broadcast_object``; rank 0 runs that part inside
``root_section``, so an error there reaches them as a ``RankFailure`` and
they raise too.  A collective that waits longer than ``TIMEOUT`` raises.

``Mesh.traffic`` counts the bytes this rank sends to other ranks, by
label: the rows of an all-to-all bound for other ranks, and for an
all-gather its piece once for each other rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from platanus3_tpu_torch.ops import bloom as bloom_mod
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import hashing
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops import solid as solid_mod
from platanus3_tpu_torch.ops.partitioned import NO_SEED
from platanus3_tpu_torch.ops.windowmin import window_min

__all__ = ["Mesh", "make_mesh", "rank_device", "choose_backend",
           "init_ranks", "TIMEOUT", "pad_batch_to_devices", "Routed",
           "or_allreduce", "route_to_owners", "route_values_back",
           "sharded_stage1", "gather_rows", "all_reduce",
           "broadcast_object", "RankFailure", "root_section",
           "all_gather_object", "broadcast_tensors", "rank_stats",
           "describe", "release_cache"]

# How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: its rank, the world size, its device,
    the backend ("nccl", "gloo", or "none" for a world of one), every
    rank's device, and the bytes it sent to other ranks by label (the
    caller clears ``traffic`` when a run begins)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    devices: list
    traffic: dict = dataclasses.field(default_factory=dict)

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def rank_device(device, local_rank=None) -> torch.device:
    """A rank's device: the CPU, or card ``local_rank % cards`` of the
    cards this process sees (``local_rank`` may be None when it sees one
    card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(f"mesh on {device}: no CUDA device is available "
                           f"(pass device='cpu' to run on the CPU)")
    if local_rank is None:
        if cards > 1:
            raise RuntimeError(
                f"mesh on {device}: this process sees {cards} cards; give "
                f"its local rank (LOCAL_RANK, or local_rank=) to pick one")
        local_rank = 0
    return torch.device("cuda", local_rank % cards)


def choose_backend(card_ids) -> str:
    """The process group's backend from every rank's card (its UUID, or
    None for a rank on the CPU): NCCL when no two ranks share a card,
    gloo on the CPU and when ranks share a card (NCCL refuses two ranks
    on one device)."""
    if any(c is None for c in card_ids):
        return "gloo"
    return "nccl" if len(set(card_ids)) == len(card_ids) else "gloo"


def _env_int(name: str, default):
    value = os.environ.get(name)
    return default if value is None else int(value)


def init_ranks(device, *, world_size: int, rank: int,
               init_method: str = "env://", local_rank=None) -> None:
    """Make this rank's device current (``rank_device``; ``local_rank``
    defaults to LOCAL_RANK), meet the other ranks at the rendezvous store,
    post this rank's card there, choose the backend from all of them
    (``choose_backend``) and join the process group on that store."""
    dev = rank_device(device, local_rank if local_rank is not None
                      else _env_int("LOCAL_RANK", None))
    card = ""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        card = str(torch.cuda.get_device_properties(dev).uuid)
    store, rank, world_size = next(dist.rendezvous(
        init_method, rank, world_size, timeout=TIMEOUT))
    store.set(f"p3_card/{rank}", card)
    cards = [store.get(f"p3_card/{r}").decode() or None
             for r in range(world_size)]
    dist.init_process_group(choose_backend(cards), store=store,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def make_mesh(device="cuda") -> Mesh:
    """This rank's mesh.  Joins the process group from the launcher's
    environment (``torch.distributed.run``: RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) unless a group exists already
    (``multihost.initialize``, given the same ``device``); without that
    environment it is a world of one rank on ``device``."""
    if not dist.is_initialized():
        world = _env_int("WORLD_SIZE", 1)
        if world <= 1:
            dev = rank_device(device, _env_int("LOCAL_RANK", 0))
            return Mesh(0, 1, dev, "none", [str(dev)])
        init_ranks(device, world_size=world, rank=_env_int("RANK", 0))
    dev = torch.device("cpu")
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(dist.get_rank(), dist.get_world_size(), dev,
                str(dist.get_backend()), [])
    mesh.devices = all_gather_object(mesh, str(dev))
    return mesh


def describe(mesh: Mesh) -> str:
    """The log line naming the backend, the world size and the devices."""
    return (f"mesh: backend {mesh.backend}, {mesh.size} ranks, devices "
            + ", ".join(f"rank {r} {d}" for r, d in enumerate(mesh.devices)))


# ---------------------------------------------------------------------------
# Collectives.  Each is the identity on a world of one rank.

def _count(mesh: Mesh, label: str, nbytes: int) -> None:
    mesh.traffic[label] = mesh.traffic.get(label, 0) + int(nbytes)


def _row_bytes(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:]) * x.element_size()


def _all_to_all(mesh: Mesh, x, send_counts, recv_counts, label: str):
    """Rows of ``x`` grouped by destination (``send_counts[d]`` rows to
    rank d) -> the rows received, grouped by source rank."""
    if mesh.size == 1:
        return x
    out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv_counts, send_counts)
    _count(mesh, label,
           (sum(send_counts) - send_counts[mesh.rank]) * _row_bytes(x))
    return out


def _all_gather(mesh: Mesh, x, label: str):
    """Equal-shaped pieces of every rank, concatenated in rank order."""
    if mesh.size == 1:
        return x
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous())
    _count(mesh, label, (mesh.size - 1) * x.numel() * x.element_size())
    return out


def release_cache(mesh: Mesh) -> None:
    """On a card, give the card back what this rank's caching allocator
    holds and no tensor uses.  Ranks that share a card call it where the
    work of a rank changes (rank 0 going on alone, a coverage pass), so a
    rank does not keep blocks another rank then cannot get: four chr21
    streaming ranks on one H100 held 83 GB of its 85 for 60 GB in use."""
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()


def all_reduce(mesh: Mesh, x, op: str, label: str = "reduce"):
    """``all_reduce`` of ``x`` in place with ``op`` "sum", "min" or "max";
    returns ``x``."""
    if mesh.size == 1:
        return x
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}[op])
    _count(mesh, label, x.numel() * x.element_size())
    return x


class RankFailure(NamedTuple):
    """What rank 0 broadcasts in place of an object when it raised."""

    message: str


def broadcast_object(mesh: Mesh, obj=None):
    """Rank 0's picklable ``obj`` on every rank; the other ranks raise
    when rank 0 sent a ``RankFailure`` (``root_section``)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    if isinstance(box[0], RankFailure) and not mesh.is_root:
        raise RuntimeError(f"rank 0 failed: {box[0].message}")
    return box[0]


@contextlib.contextmanager
def root_section(mesh: Mesh):
    """Rank 0's part of a run while the other ranks wait for it in
    ``broadcast_object``: if the part raises, rank 0 broadcasts a
    ``RankFailure`` before the error goes on, so they raise too instead
    of waiting out ``TIMEOUT``."""
    try:
        yield
    except BaseException as e:
        if mesh.size > 1 and mesh.is_root:
            broadcast_object(mesh, RankFailure(f"{type(e).__name__}: {e}"))
        raise


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def broadcast_tensors(mesh: Mesh, tensors=None):
    """Rank 0's list of tensors (or None) on every rank, on each rank's
    device; the shapes go first as an object."""
    meta = broadcast_object(mesh, None if tensors is None else
                            [(tuple(t.shape), t.dtype) for t in tensors])
    if meta is None or mesh.size == 1:
        return tensors
    out = []
    for i, (shape, dtype) in enumerate(meta):
        t = (tensors[i].contiguous() if mesh.is_root
             else torch.empty(shape, dtype=dtype, device=mesh.device))
        dist.broadcast(t, src=0)
        if mesh.is_root:
            _count(mesh, "broadcast",
                   (mesh.size - 1) * t.numel() * t.element_size())
        out.append(t)
    return out


def _exchange_counts(mesh: Mesh, send_counts) -> list:
    """Split sizes: ``send_counts[d]`` rows go to rank d -> the rows this
    rank receives from each rank (one all-to-all of int64 sizes)."""
    if mesh.size == 1:
        return list(send_counts)
    send = torch.tensor(send_counts, dtype=torch.int64, device=mesh.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.tolist()


def gather_rows(mesh: Mesh, rows, label: str = "gather"):
    """Every rank's ``rows`` (their counts may differ), concatenated in
    rank order: the counts first, then one all-gather of the rows padded
    to the largest count."""
    if mesh.size == 1:
        return rows
    counts = [int(c) for c in _all_gather(
        mesh, torch.tensor([rows.shape[0]], dtype=torch.int64,
                           device=rows.device), "sizes").tolist()]
    top = max(counts)
    pad = rows.new_zeros((top - rows.shape[0],) + tuple(rows.shape[1:]))
    got = _all_gather(mesh, torch.cat([rows, pad]), label)
    return torch.cat([got[r * top:r * top + c]
                      for r, c in enumerate(counts)])


def or_allreduce(mesh: Mesh, x, ablate: bool = False,
                 label: str = "or_allreduce"):
    """Bitwise-OR all-reduce of a 1-D integer tensor.

    No OR reduction exists on NCCL, and SUM / MAX are wrong for packed
    bitmask words, so: an all-to-all of n equal segments, the OR of the n
    received copies of this rank's segment, then an all-gather -- twice
    the bytes of an ideal all-reduce.  ``ablate=True`` keeps the local
    compute and sends nothing (the result is then wrong)."""
    n = mesh.size
    if n == 1:
        return x
    m = x.shape[0]
    pad = (-m) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    seg = x.reshape(n, -1)
    recv = seg if ablate else _all_to_all(
        mesh, seg, [1] * n, [1] * n, label)
    local = functools.reduce(torch.bitwise_or, recv.unbind(0))
    if ablate:
        return local.repeat(n)[:m]
    return _all_gather(mesh, local, label)[:m]


# ---------------------------------------------------------------------------
# Routing.

def pad_batch_to_devices(arrays, n: int):
    """Pad chunk-leading-axis arrays to a multiple of n ranks.  Padding
    chunks have valid_len 0 (no valid positions) and read_id 0 (masked
    everywhere)."""
    packed, valid_len, read_id, start, read_len = arrays
    pad = (-packed.shape[0]) % n
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((pad, packed.shape[1]), packed.dtype)])
        valid_len, read_id, start, read_len = (
            np.concatenate([a, np.zeros(pad, a.dtype)])
            for a in (valid_len, read_id, start, read_len))
    return packed, valid_len, read_id, start, read_len


class Routed(NamedTuple):
    """Bookkeeping of one all-to-all k-mer exchange.

    recv_kmers:  ``[R, L]`` the k-mers this rank owns, grouped by source
    recv_flags:  ``[R]`` 1 = valid, 2 = valid and contributes
    order:       ``[S]`` input row of each sent row, in send order
    send_counts / recv_counts: rows sent to / received from each rank
    overflow:    0-dim count of rows dropped above the bucket capacity
    """

    recv_kmers: torch.Tensor
    recv_flags: torch.Tensor
    order: torch.Tensor
    send_counts: list
    recv_counts: list
    overflow: torch.Tensor
    mesh: Mesh
    ablate: bool
    label: str


def route_to_owners(mesh: Mesh, canon, valid, contrib, cap: int, k: int,
                    ablate: bool = False, label: str = "route") -> Routed:
    """Send each valid row of ``[N, L]`` canonical k-mers to its owner rank
    ``h1 % n``.  Rows are grouped by owner with one stable sort; each
    bucket keeps at most ``cap`` rows and the rest are counted in
    ``overflow`` (JAX's fixed-capacity buckets).  Invalid rows are never
    sent.  ``ablate``: every rank keeps its own buckets."""
    n = mesh.size
    nl, l = canon.shape
    dev = canon.device
    owner = torch.where(valid, hashing.hash_kmers(canon, k, hashing.SEED_H1)
                        % n, n)
    s_owner, perm = torch.sort(owner, stable=True)
    bucket = torch.bincount(owner, minlength=n + 1)
    offs = torch.cumsum(bucket, 0) - bucket
    rank_in = torch.arange(nl, dtype=torch.int64, device=dev) - offs[s_owner]
    routed = s_owner < n
    sendable = routed & (rank_in < cap)
    overflow = (routed & (rank_in >= cap)).sum()
    order = perm[sendable]
    send_counts = bucket[:n].clamp(max=cap).tolist()
    rows = torch.cat([canon[order],
                      1 + contrib[order].to(torch.int64)[:, None]], dim=1)
    if ablate:
        recv, recv_counts = rows, send_counts
    else:
        recv_counts = _exchange_counts(mesh, send_counts)
        recv = _all_to_all(mesh, rows, send_counts, recv_counts, label)
    return Routed(recv_kmers=recv[:, :l], recv_flags=recv[:, l], order=order,
                  send_counts=send_counts, recv_counts=recv_counts,
                  overflow=overflow, mesh=mesh, ablate=ablate, label=label)


def route_values_back(routed: Routed, r_values, nl: int):
    """Inverse exchange: one value per received row -> one per original
    input row (0 for rows not sent)."""
    back = r_values if routed.ablate else _all_to_all(
        routed.mesh, r_values, routed.recv_counts, routed.send_counts,
        routed.label)
    out = torch.zeros((nl,), dtype=r_values.dtype, device=r_values.device)
    out[routed.order] = back
    return out


def _route_and_count(mesh, canon, valid, contrib, cap: int, k: int,
                     ablate: bool, label: str):
    """Route ``[N, L]`` canonical k-mers to their owners and count them
    there; returns ``(per-position counts [N], the owner's table of this
    rank's hash slice, overflow)``."""
    routed = route_to_owners(mesh, canon, valid, contrib, cap, k, ablate,
                             label)
    table, r_counts = count_mod.count_with_positions(
        routed.recv_kmers, routed.recv_flags > 0, routed.recv_flags == 2,
        k=k)
    return (route_values_back(routed, r_counts, canon.shape[0]), table,
            routed.overflow)


def sharded_stage1(mesh: Mesh, packed, valid_len, read_id, start, read_len,
                   bf: bloom_mod.BloomFilter, *, k: int, short_k: int,
                   cov_threshold: int, num_reads: int, slack: float = 1.5,
                   add_to_bloom: bool = True,
                   ablate_collectives: bool = False):
    """Distributed stage 1 (count + solidity + Bloom + node set + seeds).

    Inputs are the GLOBAL host arrays, every rank's the same; the chunk
    count must divide the mesh size (``pad_batch_to_devices``), and each
    rank works on its contiguous block.  Returns ``(node_table, bloom,
    seed_fw, has_seed, overflow)`` on every rank: the node table of all
    ranks' solid nodes, the OR-merged filter (``add_to_bloom``), the
    global first solid position's forward k-mer per read, and the rows
    dropped by all ranks' buckets (an int).

    ``ablate_collectives=True`` replaces the routes, the OR merge and the
    seed and overflow reductions with their local shapes: the same
    per-rank compute, no exchange, WRONG results by design (JAX's
    collective-share measurement).  The node tables are still gathered."""
    abl = ablate_collectives
    n = mesh.size
    c = packed.shape[0]
    assert c % n == 0
    cl = c // n
    chunk_len = packed.shape[1] * 16
    stride = chunk_len - k + 1
    p_short = chunk_len - short_k + 1
    pk = stride
    cap_s = int(math.ceil(slack * cl * p_short / n))
    cap_k = int(math.ceil(slack * cl * pk / n))
    lo = mesh.rank * cl

    def local(a):
        return torch.from_numpy(np.asarray(a[lo:lo + cl]).astype(
            np.int64)).to(mesh.device)

    packed_l, vlen_l, rid_l, start_l, rlen_l = map(
        local, (packed, valid_len, read_id, start, read_len))
    bases = kmer_mod.unpack_bases(packed_l)
    del packed_l

    # ---- short-k routing + counting ----
    s_canon, s_valid, s_owned = solid_mod.short_kmer_positions(
        bases, vlen_l, start_l, rlen_l, stride, short_k, k)
    ls = s_canon.shape[-1]
    per_pos, _, ovf_s = _route_and_count(
        mesh, s_canon.reshape(-1, ls), s_valid.reshape(-1),
        s_owned.reshape(-1), cap_s, short_k, abl, "stage1 short")
    del s_canon, s_valid, s_owned

    # ---- solidity ----
    cov_est = window_min(per_pos.reshape(cl, p_short), k - short_k + 1)
    del per_pos
    fwk, valid_k = kmer_mod.extract_kmers(bases, vlen_l, k)
    canon_k, _ = kmer_mod.canonical(fwk, k)
    owned_k = solid_mod.owned_mask(start_l, rlen_l, stride, pk, k, k)
    solid_owned = (cov_est >= cov_threshold) & valid_k & owned_k
    del cov_est, valid_k, owned_k, bases

    # ---- node set: route the solid k-mers, count them at their owner ----
    lk = canon_k.shape[-1]
    _, node_shard, ovf_k = _route_and_count(
        mesh, canon_k.reshape(-1, lk), solid_owned.reshape(-1),
        solid_owned.reshape(-1), cap_k, k, abl, "stage1 nodes")
    del canon_k
    rows = node_shard.keys.shape[0]
    shard_valid = torch.arange(rows, device=mesh.device) < node_shard.size

    # ---- Bloom: this rank's slice of the distinct node table, OR-merged --
    if add_to_bloom:
        bits = or_allreduce(mesh, bloom_mod.bloom_add(
            bf, node_shard.keys, k, mask=shard_valid).bits, ablate=abl)
    else:
        bits = bf.bits

    # ---- seeds: the global first solid owned position of each read ----
    gpos = start_l[:, None] + torch.arange(pk, dtype=torch.int64,
                                           device=mesh.device)[None, :]
    rid_b = rid_l[:, None].expand(cl, pk)
    min_pos = torch.full((num_reads,), NO_SEED, dtype=torch.int64,
                         device=mesh.device)
    min_pos.scatter_reduce_(0, rid_b.reshape(-1), torch.where(
        solid_owned, gpos, NO_SEED).reshape(-1), reduce="amin")
    if not abl:
        all_reduce(mesh, min_pos, "min")
    is_first = (solid_owned & (gpos == min_pos[rid_l][:, None])).reshape(-1)
    seed_fw = torch.zeros((num_reads, lk), dtype=torch.int64,
                          device=mesh.device)
    seed_fw.scatter_reduce_(
        0, rid_b.reshape(-1)[is_first][:, None].expand(-1, lk),
        fwk.reshape(-1, lk)[is_first], reduce="amax")
    if not abl:
        all_reduce(mesh, seed_fw, "max")
    has_seed = min_pos < NO_SEED

    ovf = (ovf_s + ovf_k).reshape(1)
    if not abl:
        all_reduce(mesh, ovf, "sum")

    # ---- merge the hash-disjoint shard tables into one node table ----
    keys = gather_rows(mesh, node_shard.keys[:int(node_shard.size)],
                       "stage1 gather")
    table = count_mod.count_kmers(
        keys, torch.ones((keys.shape[0],), dtype=torch.bool,
                         device=keys.device), k=k)
    return table, bf._replace(bits=bits), seed_fw, has_seed, int(ovf)


def rank_stats(mesh: Mesh, timer, counters: dict) -> list:
    """Every rank's spans, peak device memory (bytes, on a card:
    allocated and held by the caching allocator), bytes
    sent by label and the caller's ``counters`` (this rank's counts of
    the run), in rank order (one all-gather of objects).  The peaks are
    recorded only under ``--profile-stages`` (``StageTimer``'s
    ``profile``), and are None without it."""
    return all_gather_object(mesh, {
        "rank": mesh.rank, "device": str(mesh.device),
        "stages": dict(timer.spans),
        "peak_bytes": max(timer.peak_bytes.values(), default=None),
        "reserved_bytes": max(timer.reserved_bytes.values(), default=None),
        "traffic_bytes": dict(mesh.traffic), **counters})
