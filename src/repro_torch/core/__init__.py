"""MIND core: in-network memory management for disaggregated data centers.

The paper's primary contribution, realized as a composable library:

* :mod:`repro_torch.core.address_space`   — global VA space, range partitioning
* :mod:`repro_torch.core.allocator`       — balanced placement + first-fit
* :mod:`repro_torch.core.protection`      — decoupled (PDID, vma) -> PC table
* :mod:`repro_torch.core.directory`       — region directory (switch SRAM model)
* :mod:`repro_torch.core.coherence`       — in-network MSI protocol engine
* :mod:`repro_torch.core.bounded_splitting` — §5 adaptive region sizing
* :mod:`repro_torch.core.switch`          — staged data-plane pipeline
* :mod:`repro_torch.core.control_plane`   — switch-CPU policies + failover
* :mod:`repro_torch.core.network_model`   — Fig. 8-calibrated latency model
* :mod:`repro_torch.core.emulator`        — §7 trace-replay methodology
"""

from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.allocator import MemoryAllocator
from repro_torch.core.bounded_splitting import (
    BoundedSplitting,
    worst_case_subregions,
    worst_case_total,
)
from repro_torch.core.cache import BladePageCache
from repro_torch.core.coherence import CoherenceEngine
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.directory import CacheDirectory
from repro_torch.core.emulator import DisaggregatedRack, run_workload
from repro_torch.core.network_model import NetworkModel
from repro_torch.core.protection import ProtectionTable
from repro_torch.core.switch import InNetworkMMU, make_mmu
from repro_torch.core.types import (
    PAGE_SIZE,
    AccessType,
    MemAccess,
    MSIState,
    Perm,
    VMA,
)

__all__ = [
    "GlobalAddressSpace",
    "MemoryAllocator",
    "BoundedSplitting",
    "worst_case_subregions",
    "worst_case_total",
    "BladePageCache",
    "CoherenceEngine",
    "ControlPlane",
    "CacheDirectory",
    "DisaggregatedRack",
    "run_workload",
    "NetworkModel",
    "ProtectionTable",
    "InNetworkMMU",
    "make_mmu",
    "PAGE_SIZE",
    "AccessType",
    "MemAccess",
    "MSIState",
    "Perm",
    "VMA",
]
