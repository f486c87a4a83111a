"""Switch control plane (§3.2, §6.3): the "switch CPU" program.

Hosts the syscall intercept server (mmap/brk/munmap/mprotect from compute
blades), owns the global allocation policy, drives Bounded Splitting
epochs, installs data-plane rules, and supports failover snapshots (§3.2:
"on a failure, the data plane state is reconstructed at the backup switch
using the control plane state").
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.core.allocator import MemoryAllocator
from repro_torch.core.bounded_splitting import BoundedSplitting, EpochReport
from repro_torch.core.coherence import CoherenceEngine
from repro_torch.core.switch import InNetworkMMU
from repro_torch.core.types import VMA, MSIState, Perm
from repro_torch.telemetry import events as tev


@dataclass
class SyscallResult:
    retval: int
    vma: VMA | None = None


class ControlPlane:
    def __init__(
        self,
        mmu: InNetworkMMU,
        allocator: MemoryAllocator,
        epoch_us: float = 100_000.0,  # 100 ms default epoch (§7)
        splitting_c: float = 1.0,
    ):
        self.mmu = mmu
        self.allocator = allocator
        self.epoch_us = epoch_us
        self.splitting = BoundedSplitting(mmu.engine.directory, c=splitting_c)
        self._last_epoch_at_us = 0.0
        self.epoch_reports: list[EpochReport] = []
        # Switchless baseline racks (gam / fastswap) clear this: their
        # models never read the in-network directory, so §4.4 mmap-time
        # pre-population would only burn setup time building entries no
        # lookup will ever touch.
        self.prepopulate_on_mmap = True
        # Multi-switch racks: the VA-range shard map (set by ShardedRack).
        # The control plane stays centralized across switch shards — it
        # owns every shard's SRAM free list — but snapshots become
        # shard-aware so a single failed switch can be rebuilt from just
        # its shard's directory slice.
        self.shard_map = None
        # Optional telemetry plane (set by the rack).  Epoch events come
        # from here so both engines share one emission site, and
        # snapshots carry the registry counters for failover.
        self.telemetry = None
        # Online shard rebalancer (decentralized racks).  When
        # ``rebalance_threshold`` is set, per-VA-block access counters
        # accumulate in ``block_accesses`` over each epoch; at the epoch
        # boundary the control plane migrates hot blocks from the
        # hottest shard to the coldest one (bounded by
        # ``rebalance_max_moves`` per epoch).  Migrated region state is
        # serialized through the per-shard snapshot row format and the
        # traffic is charged at ``switch_to_switch_us`` per entry —
        # picked up stop-the-world by the engines via
        # ``take_migration_charge``.
        self.rebalance_threshold: float | None = None
        self.rebalance_max_moves = 4
        self.block_accesses: dict[int, int] | None = None
        self.rebalance_reports: list[dict] = []
        self._migration_us_pending = 0.0

    # ------------------------------------------------------------------ #
    # Syscall intercepts (§6.1 'Managing vmas').
    # ------------------------------------------------------------------ #
    def sys_mmap(self, pdid: int, length: int, perm: Perm = Perm.RW,
                 requesting_blade: int | None = None) -> SyscallResult:
        vma = self.allocator.mmap(pdid, length, perm)
        self.mmu.protection.grant_vma(vma)
        if requesting_blade is not None and self.prepopulate_on_mmap:
            # §4.4 pre-population: allocating blade gets exclusive access.
            self.mmu.engine.prepopulate(vma.base, vma.length, requesting_blade)
        return SyscallResult(retval=vma.base, vma=vma)

    def sys_munmap(self, pdid: int, base: int) -> SyscallResult:
        vma = self.allocator.vmas.get(base)
        if vma is None or vma.pdid != pdid:
            return SyscallResult(retval=-1)
        self.mmu.protection.revoke(pdid, vma.base, vma.length)
        # Tear down any directory entries covering the vma.
        d = self.mmu.engine.directory
        for e in d.entries_in(vma.base, vma.length):
            targets = e.sharer_list() if e.state == MSIState.S else (
                [e.owner] if e.owner >= 0 else [])
            for b in targets:
                c = self.mmu.engine.caches.get(b)
                if c is not None:
                    c.invalidate_region(e.base, e.size, None)
            d.remove(e)
        self.allocator.munmap(base)
        return SyscallResult(retval=0)

    def sys_mprotect(self, pdid: int, base: int, length: int, perm: Perm) -> SyscallResult:
        self.mmu.protection.revoke(pdid, base, length)
        self.mmu.protection.grant(pdid, base, length, perm)
        return SyscallResult(retval=0)

    # ------------------------------------------------------------------ #
    # Blade membership (§4.1: ranges change only on join/retire).
    # ------------------------------------------------------------------ #
    def blade_join(self, capacity: int | None = None) -> int:
        spec = self.mmu.gas.add_blade(capacity)
        self.allocator.on_blade_added(spec.blade_id)
        return spec.blade_id

    def blade_retire(self, blade_id: int) -> None:
        # Production flow would first migrate pages off (§4.4); the vmas on
        # the blade must be empty or migrated — enforced here.
        alloc = self.allocator.blades[blade_id]
        assert alloc.allocated == 0, "retire requires prior migration"
        self.allocator.on_blade_retired(blade_id)
        self.mmu.gas.retire_blade(blade_id)

    # ------------------------------------------------------------------ #
    # Epoch driver (Bounded Splitting, §5).
    # ------------------------------------------------------------------ #
    def maybe_run_epoch(self, now_us: float, split: bool = True) -> EpochReport | None:
        """Fire the epoch machinery if the epoch elapsed: Bounded
        Splitting (when ``split``) followed by the shard rebalancer
        (when enabled).  Both engines call this at the same boundaries
        on the same objects, so everything below is parity-safe by
        construction."""
        if now_us - self._last_epoch_at_us < self.epoch_us:
            return None
        self._last_epoch_at_us = now_us
        report = None
        if split:
            report = self.splitting.run_epoch()
            self.epoch_reports.append(report)
            if self.telemetry is not None:
                self.telemetry.event(tev.EPOCH, targets=report.splits,
                                     false_pages=report.merges,
                                     pages=report.directory_entries)
        if self.rebalance_threshold is not None:
            self._run_rebalance()
        return report

    # ------------------------------------------------------------------ #
    # Online shard rebalancing (decentralized racks).
    # ------------------------------------------------------------------ #
    def enable_rebalancer(self, threshold: float, max_moves: int = 4) -> None:
        """Migrate hot VA blocks at epoch boundaries whenever the
        hottest shard saw more than ``threshold``x the accesses of the
        coldest one (``threshold`` > 1)."""
        assert threshold > 1.0
        assert max_moves >= 1
        self.rebalance_threshold = threshold
        self.rebalance_max_moves = max_moves
        self.block_accesses = {}

    def take_migration_charge(self) -> float:
        """Drain the pending migration latency (us).  The engines charge
        it stop-the-world: every thread stalls while region state moves
        between switches over the switch-to-switch links."""
        us, self._migration_us_pending = self._migration_us_pending, 0.0
        return us

    def _run_rebalance(self) -> None:
        smap = self.shard_map
        acc = self.block_accesses
        if smap is None or smap.num_shards < 2 or not acc:
            if acc:
                acc.clear()
            return
        d = self.mmu.engine.directory
        ns = smap.num_shards
        lg = smap.home_log2
        shard_acc = [0] * ns
        for blk, c in acc.items():
            shard_acc[smap.home_of(blk << lg)] += c
        hop = self.mmu.network.cross_shard_us()
        moves: list[dict] = []
        entries_total = 0
        for _ in range(self.rebalance_max_moves):
            hot = max(range(ns), key=lambda s: (shard_acc[s], -s))
            cold = min(range(ns), key=lambda s: (shard_acc[s], s))
            diff = shard_acc[hot] - shard_acc[cold]
            if hot == cold or shard_acc[hot] <= self.rebalance_threshold * max(1, shard_acc[cold]):
                break
            # Hottest block currently homed at the hot shard whose move
            # strictly reduces the imbalance and fits the destination's
            # SRAM budget.  Deterministic: ties break on block id.
            best = None
            for blk, c in sorted(acc.items(), key=lambda kv: (-kv[1], kv[0])):
                if smap.home_of(blk << lg) != hot or not 0 < c < diff:
                    continue
                if d.shard_budgets is not None:
                    k = sum(1 for key in d.entries if key[0] >> lg == blk)
                    if len(d._shard_lru[cold]) + k > d.shard_budgets[cold]:
                        continue  # would overflow the destination ASIC
                self._migrate_block(blk, cold, moves)
                entries_total += moves[-1]["entries"]
                shard_acc[hot] -= c
                shard_acc[cold] += c
                best = blk
                break
            if best is None:
                break
        if moves:
            migration_us = entries_total * hop
            self._migration_us_pending += migration_us
            self.rebalance_reports.append({
                "epoch": self.splitting.epoch,
                "moves": moves,
                "entries_moved": entries_total,
                "migration_us": migration_us,
            })
        acc.clear()

    def _migrate_block(self, blk: int, dst: int, moves: list[dict]) -> None:
        """Re-home one VA block: ship its directory slice to ``dst``
        through the per-shard snapshot row format (the §3.2 failover
        path doubles as the migration transport), flip the shard map,
        and rebuild the shard-local recency lists."""
        smap = self.shard_map
        d = self.mmu.engine.directory
        lg = smap.home_log2
        src = smap.home_of(blk << lg)
        keys = [k for k in d.lru_keys() if k[0] >> lg == blk]
        # Serialize exactly what snapshot(shard=...) would for these rows
        # and round-trip it — the state that crosses the s2s link.
        rows = json.loads(json.dumps([
            {"base": e.base, "log2": e.size_log2, "state": int(e.state),
             "sharers": e.sharers, "owner": e.owner}
            for e in (d.entries[k] for k in keys)
        ]))
        smap.set_home(blk, dst)
        d._rebuild_shard_lists()
        moves.append({"block": blk, "from": src, "to": dst, "entries": len(rows)})
        if self.telemetry is not None:
            self.telemetry.event(tev.REBALANCE, base=blk << lg, log2=lg,
                                 targets=dst, pages=len(rows),
                                 us=len(rows) * self.mmu.network.cross_shard_us())

    # ------------------------------------------------------------------ #
    # Failover (§3.2): serialize enough control-plane state to rebuild the
    # data plane on a backup switch.  Directory entries are serialized
    # coldest-first (LRU order) and re-installed in that order on
    # restore, so the backup switch makes the *same* capacity-eviction
    # decisions the failed switch would have.
    #
    # Sharded racks: when a shard map is attached, every entry carries
    # its home switch, and ``snapshot(shard=k)`` serializes only shard
    # k's directory slice (plus the global vma/blade state every switch
    # replicates) — the state a backup for switch k needs.  Entries stay
    # in global LRU order, so restoring each shard preserves the
    # relative recency of its entries.
    # ------------------------------------------------------------------ #
    def snapshot(self, shard: int | None = None) -> str:
        d = self.mmu.engine.directory
        smap = self.shard_map
        if shard is not None:
            if smap is None:
                raise ValueError(
                    "snapshot(shard=...) requires a shard map: this control "
                    "plane manages a single switch — build a ShardedRack (or "
                    "set control_plane.shard_map) before taking per-shard "
                    "snapshots")
            if not 0 <= shard < smap.num_shards:
                raise ValueError(
                    f"shard {shard} out of range for a "
                    f"{smap.num_shards}-shard map")
        keys = [k for k in d.lru_keys()
                if shard is None or smap.home_of_key(k) == shard]
        prepop = self.mmu.engine._prepopulated
        state = {
            "blades": {
                str(b): {"va_base": s.va_base, "capacity": s.capacity}
                for b, s in self.mmu.gas.blades.items()
            },
            "vmas": [
                {
                    "base": v.base,
                    "length": v.length,
                    "pdid": v.pdid,
                    "perm": int(v.perm),
                    "blade_id": v.blade_id,
                }
                for v in self.allocator.vmas.values()
            ],
            "directory": [
                {
                    "base": e.base,
                    "log2": e.size_log2,
                    "state": int(e.state),
                    "sharers": e.sharers,
                    "owner": e.owner,
                    # Pre-population flag and current-epoch counters: the
                    # backup switch must serve §4.4 local hits for
                    # never-fetched pages and make the same
                    # Bounded-Splitting decisions at the next epoch.
                    "prepop": int((e.base, e.size_log2) in prepop),
                    "fic": d.stats[(e.base, e.size_log2)].false_invalidations,
                    "acc": d.stats[(e.base, e.size_log2)].accesses,
                    **({"home": smap.home_of_key((e.base, e.size_log2))}
                       if smap is not None else {}),
                }
                # Coldest-first: restore re-installs in this order, which
                # reproduces the recency ranking byte for byte.
                for e in (d.entries[k] for k in keys)
            ],
            "splitting": {"c": self.splitting.c, "epoch": self.splitting.epoch},
        }
        if self.allocator.policy_name != "first_fit":
            # Non-default fit policies carry their exact free structure:
            # first-fit free lists are the unique complement of the live
            # vmas (re-carving reproduces them, keeping default snapshots
            # byte-identical to the seed format), but buddy split trees
            # and segregated class arenas are NOT derivable from the vma
            # set alone — a backup switch restoring without this state
            # would make different future placement decisions.
            state["alloc"] = {
                "policy": self.allocator.policy_name,
                "pow2_align": self.allocator.pow2_align,
                "blades": {str(b): a.export_state()
                           for b, a in self.allocator.blades.items()},
            }
        if self.telemetry is not None:
            # Per-shard snapshots keep only the failed switch's slice of
            # the registry (counters labeled shard=k); the backup resumes
            # counting from there instead of zero.
            state["telemetry"] = self.telemetry.metrics.counters_to_jsonable(
                shard=shard)
        if smap is not None:
            state["shards"] = {
                "num_shards": smap.num_shards,
                "home_log2": smap.home_log2,
                "shard": shard,  # None == full-rack snapshot
                # Rebalancer re-homing decisions are control-plane state
                # every switch replicates (a backup must route the same).
                "overrides": {str(b): s for b, s in smap.overrides.items()},
            }
        return json.dumps(state)

    @staticmethod
    def restore(snapshot_json: str, cache_bytes_per_blade: int,
                num_compute_blades: int) -> "ControlPlane":
        """Rebuild a full switch (data plane included) from a snapshot."""
        from repro_torch.core.switch import make_mmu
        from repro_torch.core.types import VMA as _VMA, Perm as _Perm

        state = json.loads(snapshot_json)
        alloc_state = state.get("alloc")
        mmu, alloc = make_mmu(
            num_memory_blades=len(state["blades"]),
            num_compute_blades=num_compute_blades,
            cache_bytes_per_blade=cache_bytes_per_blade,
            alloc_policy=(alloc_state["policy"] if alloc_state
                          else "first_fit"),
        )
        cp = ControlPlane(mmu, alloc)
        # Honour the snapshot's per-blade geometry: make_mmu builds
        # full-span blades, but the failed switch may have managed
        # smaller (or heterogeneous) capacities — a restored allocator
        # with the wrong capacity silently makes different placement
        # decisions under pressure.
        from repro_torch.core.allocator import BladeAllocator as _BA
        from repro_torch.core.types import BladeSpec as _BladeSpec

        for b, s in state["blades"].items():
            bid = int(b)
            spec = mmu.gas.blades[bid]
            if (spec.capacity, spec.va_base) != (s["capacity"], s["va_base"]):
                mmu.gas.blades[bid] = _BladeSpec(bid, s["va_base"], s["capacity"])
                alloc.blades[bid] = _BA(s["va_base"], s["capacity"],
                                        alloc.policy_name)
        if alloc_state:
            # Non-default fit policy: load the serialized free structure
            # bit-exactly, then register vmas without re-carving — the
            # backup allocator re-carves exact ranges and makes the same
            # future decisions the failed switch would have.
            alloc.pow2_align = bool(alloc_state["pow2_align"])
            for b, bs in alloc_state["blades"].items():
                alloc.blades[int(b)].load_state(bs)
        for v in state["vmas"]:
            vma = _VMA(v["base"], v["length"], v["pdid"], _Perm(v["perm"]), v["blade_id"])
            # First-fit free lists are the unique sorted+coalesced
            # complement of the vma set, so exact re-carving rebuilds
            # them; policy-state snapshots already carry theirs.
            alloc.register_vma(vma, carve=alloc_state is None)
            mmu.protection.grant_vma(vma)
        _install_snapshot_rows(mmu.engine, state["directory"])
        cp.splitting.c = state["splitting"]["c"]
        cp.splitting.epoch = state["splitting"]["epoch"]
        if "telemetry" in state:
            from repro_torch.telemetry import Telemetry

            cp.telemetry = Telemetry()
            cp.telemetry.metrics.load_counters(state["telemetry"])
        if "shards" in state:
            from repro_torch.core.switch import ShardMap

            cp.shard_map = ShardMap(
                num_shards=state["shards"]["num_shards"],
                home_log2=state["shards"]["home_log2"],
                overrides={int(b): s for b, s in
                           state["shards"].get("overrides", {}).items()})
        return cp

    # ------------------------------------------------------------------ #
    def restore_shard(self, snapshot_json: str) -> int:
        """In-place failover: re-install one shard's directory slice
        (taken with ``snapshot(shard=k)``) into the *live* rack after
        the shard's switch died and its slice was lost.  Rows go back
        coldest-first, so the shard-local recency order — the only
        recency state eviction depends on under per-shard budgets — is
        reproduced exactly.  Returns the number of entries restored.

        No latency is charged: the paper's backup switch already holds
        the control-plane state (§3.2), so recovery is off the critical
        path of the replayed trace.
        """
        state = json.loads(snapshot_json)
        shard = state.get("shards", {}).get("shard")
        if shard is None:
            raise ValueError("restore_shard needs a snapshot(shard=k) "
                             "snapshot, not a full-rack one")
        d = self.mmu.engine.directory
        hold, d.telemetry = d.telemetry, None
        try:
            _install_snapshot_rows(self.mmu.engine, state["directory"])
        finally:
            d.telemetry = hold
        if d.shard_budgets is not None:
            d._rebuild_shard_lists()
        return len(state["directory"])


def _install_snapshot_rows(engine: CoherenceEngine, rows: list[dict]) -> None:
    """Re-install serialized directory rows (coldest-first order) with
    their pre-population flags and current-epoch counters."""
    d = engine.directory
    for e in rows:
        ent = d._install(e["base"], e["log2"], MSIState(e["state"]),
                         e["sharers"], e["owner"])
        key = (ent.base, ent.size_log2)
        if e.get("prepop"):
            engine._prepopulated.add(key)
        st = d.stats[key]
        st.false_invalidations = e.get("fic", 0)
        st.accesses = e.get("acc", 0)
