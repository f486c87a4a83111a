"""The slice end to end in the regimes with host pre-passes.

Bounded-Splitting epochs (speculate-and-truncate chunking), directory
capacity evictions (ptype-1 packets), blade-cache evictions (ptype-2
packets), ``downgrade_keeps_copy`` and a 2-shard rack: the port's batched
replay on the CPU is bytewise equal to the JAX engine and equal to the
port's scalar oracle to the reference's tolerance (see
``test_torch_dataplane.py`` for the helpers and the plain cells).
"""

from repro.core import traces as JT

from test_torch_dataplane import run_three, zipf_trace


def test_epochs_with_splitting():
    trace = JT.ycsb_trace("zipf", num_threads=4, read_ratio=0.5,
                          accesses_per_thread=600, store_mb=4, seed=7)
    rp, _, _, _ = run_three(trace, system="mind", epoch_us=4000.0)
    assert len(rp.epoch_reports) >= 2


def test_directory_capacity_eviction():
    trace = JT.WORKLOADS["TF"](num_threads=4, accesses_per_thread=250)
    rp, _, _, evictions = run_three(trace, system="mind",
                                    splitting_enabled=False,
                                    max_directory_entries=600)
    assert rp.stats.accesses == len(trace) and evictions > 0


def test_blade_cache_eviction():
    rp, _, _, _ = run_three(zipf_trace(), system="mind",
                            splitting_enabled=False,
                            cache_bytes_per_blade=1 << 15)
    assert rp.stats.evicted_dirty > 0 and rp.stats.evicted_clean > 0


def test_downgrade_keeps_copy():
    trace = JT.WORKLOADS["GC"](num_threads=4, accesses_per_thread=250)
    run_three(trace, system="mind", splitting_enabled=False,
              downgrade_keeps_copy=True)


def test_two_shard_rack():
    trace = JT.WORKLOADS["XS"](num_threads=4, accesses_per_thread=250)
    rp, rj, _, _ = run_three(trace, sharded=True, num_shards=2,
                             system="mind", splitting_enabled=False)
    assert rp.num_shards == 2
    assert rp.shard_accesses == rj.shard_accesses
    assert rp.cross_shard_accesses == rj.cross_shard_accesses > 0
