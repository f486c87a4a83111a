"""Typed coherence events for the flight recorder.

The benchmark's copy of the JAX package's
``src/repro/telemetry/events.py``, the scalar oracle, cut to what a
replay of one ``mind`` rack on one switch reaches (cut: all but the
event kinds that the kept code names (the reference runs with telemetry
off)). Every definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations


ACCESS = "access"
INVALIDATE = "invalidate"
DOWNGRADE = "downgrade"
WRITEBACK = "writeback"
DIR_INSTALL = "dir_install"
DIR_EVICT = "dir_evict"
CACHE_EVICT_CLEAN = "cache_evict_clean"
CACHE_EVICT_DIRTY = "cache_evict_dirty"
REGION_SPLIT = "region_split"
REGION_MERGE = "region_merge"
EPOCH = "epoch"
RETRY = "retry"
TIMEOUT = "timeout"


#: Kinds that only one engine can produce; dropped before parity diffs.
