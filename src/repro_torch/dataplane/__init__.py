"""Batched in-network data-plane engine: vectorized trace replay.

The PyTorch port of ``repro.dataplane``.  For the MIND systems (``mind``,
``mind-pso``, ``mind-pso+``) the table export
(:mod:`repro_torch.dataplane.tables`) and conflict scheduler
(:mod:`repro_torch.dataplane.scheduler`) are host code carried over as
they are; the pipeline (:mod:`repro_torch.dataplane.engine`) runs the
TCAM and MSI wave-loop stages as hand-written CUDA kernels on the card
(their plain PyTorch versions on the CPU, when the caller asks for it
with ``engine_options={"device": "cpu"}``).

The no-switch baselines (gam, fastswap) have no switch and so no kernel:
their batched replays (:mod:`repro_torch.dataplane.baselines`) are NumPy
host code in both packages, copied as they are and held to their scalar
oracles bytewise.  They take ``chunk_size`` only; ``device`` is an option
of the mind engine.
"""

from repro_torch.dataplane.baselines import (
    BASELINE_PHASES,
    FastswapBatchedReplay,
    GamBatchedReplay,
)
from repro_torch.dataplane.engine import BatchedDataPlane, UnsupportedByBatchedEngine
from repro_torch.dataplane.scheduler import (
    WaveSchedule,
    build_wave_schedule,
    partition_by_shard,
)
from repro_torch.dataplane.tables import DataPlaneState, PageMap, RegionTable

__all__ = [
    "BASELINE_PHASES",
    "BatchedDataPlane",
    "DataPlaneState",
    "FastswapBatchedReplay",
    "GamBatchedReplay",
    "PageMap",
    "RegionTable",
    "UnsupportedByBatchedEngine",
    "WaveSchedule",
    "build_wave_schedule",
    "partition_by_shard",
]
