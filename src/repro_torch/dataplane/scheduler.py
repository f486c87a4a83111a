"""Conflict scheduler: lanes of serialized waves for the batched pipeline.

The switch processes independent packets at line rate but serializes
packets that hit the same directory region (the recirculation path,
§6.3).  The scheduler reproduces that: the active regions of a batch are
partitioned across ``lanes`` parallel lanes, every access to a region is
routed to that region's lane, and each lane replays its packets strictly
in trace order.  Step ``i`` of the engine's compiled loop is therefore
one *wave*: at most ``lanes`` packets, all guaranteed to touch distinct
regions (conflict-free), while consecutive accesses to a shared region
sit in consecutive waves of the same lane (serialized).

Lane assignment is longest-processing-time greedy: regions sorted by
batch access count, each placed on the least-loaded lane, which keeps
the hottest (most serialized) regions on separate lanes and bounds the
wave count by the hottest region's access count rather than the batch
size.

Eviction packets ride the same machinery: a *directory* capacity
eviction is a packet of the victim region's slot, and a *blade-cache*
eviction is a packet of the slot of the active region covering the
victim page — so each serializes, in stream order, against every access
and invalidation that could observe the state it mutates.  Overlapping
regions (possible after capacity evictions re-cover split children at a
coarser granularity) share cache-plane bits, so the engine passes them
as one scheduling *group* via ``group_of_slot`` and they are pinned to
one lane rather than racing across lanes.

Multi-switch (sharded-directory) racks add one partitioning level
*above* lanes: :func:`partition_by_shard` splits a chunk's packet
stream by the home shard of each packet's region, and the engine builds
one wave schedule — and runs one TCAM/MSI kernel invocation — per
shard.  The split is exact because shards partition the VA space at
max-region-block granularity: two packets of different shards can never
touch the same region (or overlapping regions), so per-shard replay in
stream order is indistinguishable from the single-switch interleaving.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class WaveSchedule:
    """Device-ready wave schedule for one batch.

    ``acc_index``/``acc_valid`` are ``[lanes, num_waves]``: wave ``i`` of
    lane ``g`` replays original batch position ``acc_index[g, i]`` (``-1``
    padding where ``acc_valid`` is False).  The engine gathers whatever
    per-access streams it needs through ``acc_index``; per-region state
    is addressed by the ``lane_of_slot``/``local_of_slot`` maps.
    """

    lanes: int
    num_waves: int
    slots_per_lane: int  # max lane-local slots (without dummy)
    lane_of_slot: np.ndarray  # int32 [S_active]
    local_of_slot: np.ndarray  # int32 [S_active]
    lane_len: np.ndarray  # int32 [lanes]
    acc_valid: np.ndarray  # bool  [lanes, num_waves]
    acc_index: np.ndarray  # int64 [lanes, num_waves] original batch pos


def partition_by_shard(
    slot_of_pkt: np.ndarray,
    num_slots: int,
    shard_of_slot: np.ndarray | None = None,
) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """Split one chunk's packet stream into per-home-shard subsets.

    Args:
      slot_of_pkt: int array [P] of active-slot ids in stream order.
      num_slots: number of active slots in the chunk.
      shard_of_slot: optional int array [num_slots] of home-shard ids.
        ``None`` (the single-switch rack) yields one part holding the
        whole stream.

    Returns a list of ``(shard, pkt_idx, slots)`` per shard present in
    the chunk: ``pkt_idx`` the packet positions homed there (ascending,
    so per-shard replay preserves stream order) and ``slots`` the
    active-slot ids the shard owns (ascending).  Every packet and every
    slot lands in exactly one part.
    """
    if shard_of_slot is None:
        return [(0, np.arange(len(slot_of_pkt), dtype=np.int64),
                 np.arange(num_slots, dtype=np.int64))]
    shard_of_slot = np.asarray(shard_of_slot)
    shard_of_pkt = shard_of_slot[slot_of_pkt]
    return [
        (int(s),
         np.flatnonzero(shard_of_pkt == s).astype(np.int64),
         np.flatnonzero(shard_of_slot == s).astype(np.int64))
        for s in np.unique(shard_of_slot).tolist()
    ]


def build_wave_schedule(
    slot_of_acc: np.ndarray,
    num_slots: int,
    lanes: int = 4,
    group_of_slot: np.ndarray | None = None,
) -> WaveSchedule:
    """Build the wave schedule for one batch.

    Args:
      slot_of_acc: int array [B] of active-slot ids (0..num_slots-1) in
        trace order.
      num_slots: number of active slots in the batch.
      lanes: parallel lane count.
      group_of_slot: optional int array [num_slots] of scheduling-group
        ids.  Slots in the same group are pinned to the same lane (and
        therefore serialize against each other in trace order) — the
        engine groups *overlapping* regions this way, since they share
        cache-plane bits and must not race across lanes.  ``None`` means
        every slot is its own group (the conflict-free default).
    """
    b = len(slot_of_acc)
    counts = np.bincount(slot_of_acc, minlength=num_slots)
    if group_of_slot is None:
        gcounts = counts
        ngroups = num_slots
        group_of_slot = np.arange(num_slots, dtype=np.int64)
    else:
        group_of_slot = np.asarray(group_of_slot, np.int64)
        ngroups = int(group_of_slot.max()) + 1 if num_slots else 0
        gcounts = np.bincount(
            group_of_slot, weights=counts, minlength=ngroups).astype(np.int64)
    # Longest-processing-time greedy: hottest groups first, each to the
    # least-loaded lane, so the wave count approaches the hottest
    # region's serialization floor instead of the batch size.
    order = np.argsort(-gcounts, kind="stable")
    lane_of_slot = np.empty(num_slots, np.int32)
    if num_slots:
        lane_of_group = np.empty(ngroups, np.int32)
        load = [(0, g) for g in range(lanes)]
        heapq.heapify(load)
        for s in order.tolist():
            cnt, g = heapq.heappop(load)
            lane_of_group[s] = g
            heapq.heappush(load, (cnt + int(gcounts[s]), g))
        lane_of_slot[:] = lane_of_group[group_of_slot]
    # Lane-local dense slot ids.
    by_lane = np.argsort(lane_of_slot, kind="stable")
    lane_sorted = lane_of_slot[by_lane]
    lane_starts = np.searchsorted(lane_sorted, np.arange(lanes))
    local_of_slot = np.empty(num_slots, np.int32)
    local_of_slot[by_lane] = (
        np.arange(num_slots, dtype=np.int32) - lane_starts[lane_sorted]
    )
    slots_per_lane = (
        int(np.bincount(lane_of_slot, minlength=lanes).max()) if num_slots else 0
    )

    lane_of_acc = lane_of_slot[slot_of_acc] if b else np.zeros(0, np.int32)
    lane_len = np.bincount(lane_of_acc, minlength=lanes).astype(np.int32)
    num_waves = int(lane_len.max()) if b else 0

    shape = (lanes, num_waves)
    acc_valid = np.zeros(shape, bool)
    acc_index = np.full(shape, -1, np.int64)
    for g in range(lanes):
        idx = np.flatnonzero(lane_of_acc == g)  # ascending == trace order
        k = len(idx)
        acc_valid[g, :k] = True
        acc_index[g, :k] = idx

    return WaveSchedule(
        lanes=lanes,
        num_waves=num_waves,
        slots_per_lane=slots_per_lane,
        lane_of_slot=lane_of_slot,
        local_of_slot=local_of_slot,
        lane_len=lane_len,
        acc_valid=acc_valid,
        acc_index=acc_index,
    )
