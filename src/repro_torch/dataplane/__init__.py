"""Batched in-network data-plane engine: vectorized trace replay.

The PyTorch port of ``repro.dataplane`` for the MIND systems (``mind``,
``mind-pso``, ``mind-pso+``): the table export
(:mod:`repro_torch.dataplane.tables`) and conflict scheduler
(:mod:`repro_torch.dataplane.scheduler`) are host code carried over as
they are; the pipeline (:mod:`repro_torch.dataplane.engine`) runs the
TCAM and MSI wave-loop stages as hand-written CUDA kernels.  The batched
replays of the no-switch baselines (gam, fastswap) are not ported yet.
"""

from repro_torch.dataplane.engine import BatchedDataPlane, UnsupportedByBatchedEngine
from repro_torch.dataplane.scheduler import (
    WaveSchedule,
    build_wave_schedule,
    partition_by_shard,
)
from repro_torch.dataplane.tables import DataPlaneState, PageMap, RegionTable

__all__ = [
    "BatchedDataPlane",
    "DataPlaneState",
    "PageMap",
    "RegionTable",
    "UnsupportedByBatchedEngine",
    "WaveSchedule",
    "build_wave_schedule",
    "partition_by_shard",
]
