"""The fault plane in the port vs the JAX package.

Blade kill/restore schedules (a killed blade's memory re-homed in
mid-trace, the batched replay's chunks cut at each fault index), the
lossy fabric's retry draw and the two together: the port's batched
replay on the CPU equals the JAX engine's bytewise, fault reports and
telemetry included, and equals the port's scalar oracle at the
reference's bar (``tests/test_faults.py``).  The port's
``check_invariants`` finds the port's streams clean.
"""

import pytest

from repro.core import traces as JT

from repro_torch.core import faults as flt
from repro_torch.core.emulator import DisaggregatedRack as PortRack
from repro_torch.core.types import NetworkConstants
from repro_torch.telemetry import check_invariants
from repro_torch.telemetry.events import TIMEOUT

from test_torch_dataplane import run_three

LOSSY = dict(fabric_loss_prob=0.25, fabric_timeout_us=12.0,
             fabric_backoff=2.0, fabric_timeout_cap_us=96.0,
             fabric_max_retries=3, fabric_seed=11)

KW = dict(num_compute_blades=2, threads_per_blade=2, splitting_enabled=False,
          telemetry=True)


def _trace(n=250, seed=3):
    return JT.tf_trace(num_threads=4, accesses_per_thread=n, seed=seed)


def _xs():
    return JT.sharded_conflict_trace(num_threads=4, accesses_per_thread=250,
                                     num_shards=4, blocks_per_shard=2,
                                     seed=9)


def _kill_plan(n):
    return [(n // 4, flt.BLADE_KILL, 0), (n // 2, flt.BLADE_RESTORE, 0),
            (3 * n // 4, flt.BLADE_KILL, 1)]


def _clean(result):
    """The port's batched stream is clean; run_three has already held the
    scalar oracle's stream equal to it."""
    assert check_invariants(result.telemetry) == []


# --------------------------------------------------------------------- #
# Blade kill/restore.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("durable", [False, True])
def test_blade_kill_plan_equals_the_reference(durable):
    tr = _trace()
    rp, _, _, _ = run_three(tr, plan=_kill_plan(len(tr)),
                            durable_writebacks=durable, **KW)
    assert [f.kind for f in rp.fault_reports] == [
        flt.BLADE_KILL, flt.BLADE_RESTORE, flt.BLADE_KILL]
    assert rp.fault_reports[0].vmas_remapped > 0
    assert sum(f.pages_written for f in rp.fault_reports) > 0
    if durable:
        assert all(f.pages_dirty_lost == 0 for f in rp.fault_reports)
    else:
        assert all(f.pages_dirty_refetched == 0 for f in rp.fault_reports)
    _clean(rp)


def test_back_to_back_kill_restore_cycles():
    plan = []
    for c, i in enumerate(range(100, 112, 2)):
        plan += [(i, flt.BLADE_KILL, c % 2), (i + 1, flt.BLADE_RESTORE, c % 2)]
    rp, _, _, _ = run_three(_trace(), plan=plan, **KW)
    assert len(rp.fault_reports) == len(plan)


# --------------------------------------------------------------------- #
# Lossy fabric.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("system", ["mind", "mind-pso", "mind-pso+"])
def test_lossy_fabric_equals_the_reference(system):
    rp, _, _, _ = run_three(_trace(), constants=LOSSY,
                            **{**KW, "system": system})
    assert rp.latency_breakdown_us["retry"] > 0.0


def test_lossy_fabric_under_directory_pressure():
    rp, _, _, evictions = run_three(_trace(), constants=LOSSY,
                                    max_directory_entries=120, **KW)
    assert evictions > 0
    assert any(e.kind == TIMEOUT for e in rp.telemetry.recorder.events)


def test_lossy_fabric_on_sharded_rack():
    rp, _, _, _ = run_three(_xs(), sharded=True, num_shards=2,
                            constants=LOSSY, **KW)
    assert rp.cross_shard_accesses > 0
    assert rp.latency_breakdown_us["retry"] > 0.0


@pytest.mark.parametrize("system", ["gam", "fastswap"])
def test_lossy_fabric_refused_without_switch(system):
    with pytest.raises(ValueError, match="no switch"):
        PortRack(system=system, num_compute_blades=2, threads_per_blade=2,
                 constants=NetworkConstants(**LOSSY))


# --------------------------------------------------------------------- #
# Chaos: faults and the lossy fabric together.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("durable", [False, True])
def test_chaos_faults_and_fabric_together(durable):
    tr = _trace()
    rp, _, _, _ = run_three(tr, plan=_kill_plan(len(tr)), constants=LOSSY,
                            durable_writebacks=durable, **KW)
    assert len(rp.fault_reports) == 3
    assert rp.latency_breakdown_us["retry"] > 0.0
    _clean(rp)


# --------------------------------------------------------------------- #
# The port's invariant checker on the port's streams.
# --------------------------------------------------------------------- #
_REGIMES = {
    "plain": dict(),
    "pso": dict(system="mind-pso"),
    "dir_pressure": dict(max_directory_entries=120),
    "cache_pressure": dict(cache_bytes_per_blade=1 << 14),
    "epochs": dict(splitting_enabled=True, epoch_us=4000.0),
    "sharded": dict(sharded=True, num_shards=2),
}


@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_invariants_clean_on_parity_regimes(regime):
    kw = {**KW, **_REGIMES[regime]}
    rp, _, _, _ = run_three(_xs() if kw.get("sharded") else _trace(), **kw)
    _clean(rp)
