"""Per-shard SRAM budgets, the online rebalancer and switch kills in the
port vs the JAX package.

Every cell replays one trace on a budgeted ``ShardedRack`` (each shard's
kernels launched on that shard's packets): the port's batched replay on
the CPU equals the JAX engine's bytewise (stats, runtimes, telemetry,
rebalance and fault reports) and the port's scalar oracle at the
reference's bar (``tests/test_rebalance.py``).  A switch kill is held to
the JAX engine's replay of the same schedule; convergence to the
uninterrupted run is not asserted here.
"""

import pytest

from repro.core import traces as JT

from repro_torch.core import faults as flt

from test_torch_dataplane import run_three

ZERO_HOP = dict(switch_to_switch_us=0.0)

# (max_directory_entries, cache_bytes, epoch_us or None, per-shard budget)
_REGIMES = {
    "dir_pressure": (30_000, 512 << 20, None, 24),
    "epochs": (30_000, 512 << 20, 2500.0, 4096),
    "cocktail": (30_000, 1 << 15, 2500.0, 32),
    "xs": (30_000, 512 << 20, 2500.0, 64),
}


def _trace(regime, seed=9, n=250):
    if regime == "xs":
        return JT.sharded_conflict_trace(
            num_threads=4, accesses_per_thread=400, num_shards=4,
            blocks_per_shard=2, conflict_frac=0.5, write_frac=0.30,
            hot_pages_per_block=24, private_kb_per_thread=128, seed=seed)
    return JT.sharded_conflict_trace(
        num_threads=4, accesses_per_thread=n, conflict_frac=0.5,
        write_frac=0.3, hot_pages_per_block=12, private_kb_per_thread=64,
        seed=seed)


def _budgeted(regime, num_shards, rebalance=False, constants=ZERO_HOP,
              **extra):
    maxdir, cache_b, epoch, budget = _REGIMES[regime]
    return run_three(
        _trace(regime), sharded=True, telemetry=True, num_shards=num_shards,
        shard_slot_budgets=budget,
        rebalance_threshold=1.5 if rebalance else None, constants=constants,
        system="mind", num_compute_blades=2, threads_per_blade=2,
        max_directory_entries=maxdir, cache_bytes_per_blade=cache_b,
        splitting_enabled=epoch is not None, epoch_us=epoch or 10_000.0,
        **extra)


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("regime", ["dir_pressure", "cocktail", "xs"])
def test_budget_parity(regime, num_shards):
    """Shard-local eviction under per-switch budgets."""
    rp, _, _, evictions = _budgeted(regime, num_shards)
    assert rp.num_shards == num_shards
    assert sum(rp.shard_accesses) == rp.stats.accesses + rp.stats.faults
    if regime != "xs":
        assert evictions > 0


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("regime", ["xs", "epochs", "cocktail"])
def test_rebalancer_parity(regime, num_shards):
    """The rebalancer live, with the default switch-to-switch hop so every
    migration is charged: the same blocks move to the same shards at the
    same microseconds in all three replays."""
    rp, _, _, _ = _budgeted(regime, num_shards, rebalance=True,
                            constants=None)
    if regime == "xs":
        assert rp.rebalance_reports
        assert all(rep["migration_us"] > 0 for rep in rp.rebalance_reports)


@pytest.mark.parametrize("rebalance", [False, True])
def test_switch_kill_and_restore_at_four_shards(rebalance):
    """Kill each of the four switches once (a kill restores its slice
    from the per-shard snapshot) mid-trace: the port equals the JAX
    engine's replay of the same schedule."""
    n = 4 * 250
    plan = [(n // 5 * (k + 1), flt.SWITCH_KILL, k) for k in range(4)]
    rp, _, _, _ = _budgeted("cocktail", 4, rebalance=rebalance, plan=plan)
    assert [f.kind for f in rp.fault_reports] == [flt.SWITCH_KILL] * 4
    assert sum(f.entries_restored for f in rp.fault_reports) > 0


def test_mixed_blade_and_switch_faults_on_sharded_rack():
    plan = [(200, flt.BLADE_KILL, 0), (400, flt.SWITCH_KILL, 1),
            (500, flt.BLADE_RESTORE, 0), (700, flt.BLADE_KILL, 1),
            (900, flt.SWITCH_KILL, 0)]
    rp, _, _, _ = _budgeted("epochs", 2, rebalance=True, plan=plan)
    assert [f.kind for f in rp.fault_reports] == [
        flt.BLADE_KILL, flt.SWITCH_KILL, flt.BLADE_RESTORE,
        flt.BLADE_KILL, flt.SWITCH_KILL]
