"""Per-system model layer: one :class:`SystemModel` per compared system.

The rack (:class:`~repro_torch.core.emulator.DisaggregatedRack`) no longer
branches on ``self.system``: it builds a model with :func:`make_model`
and dispatches every per-access step, epoch boundary, telemetry wiring
and batched-engine construction through it.

=============  =======================  ====================================
system         model                    batched engine
=============  =======================  ====================================
``mind``       :class:`MindModel`       ``repro_torch.dataplane.engine``
``mind-pso``   :class:`MindModel`       (TCAM + MSI wave kernels)
``mind-pso+``  :class:`MindModel`
``gam``        :class:`GamModel`        ``repro_torch.dataplane.baselines``
``fastswap``   :class:`FastswapModel`   (directory-free vectorized replay)
=============  =======================  ====================================
"""

from __future__ import annotations

from repro_torch.core.systems.base import SystemModel
from repro_torch.core.systems.fastswap import FastswapModel
from repro_torch.core.systems.gam import GamModel, gam_kind
from repro_torch.core.systems.mind import MindModel

#: Every system name the rack accepts.
SYSTEMS = ("mind", "mind-pso", "mind-pso+", "gam", "fastswap")


def make_model(system: str, rack) -> SystemModel:
    """Build the model for ``system``, bound to ``rack``."""
    if system.startswith("mind"):
        return MindModel(rack, name=system)
    if system == "gam":
        return GamModel(rack)
    if system == "fastswap":
        return FastswapModel(rack)
    raise ValueError(f"unknown system {system!r}; expected one of {SYSTEMS}")


__all__ = [
    "SYSTEMS",
    "SystemModel",
    "MindModel",
    "GamModel",
    "FastswapModel",
    "gam_kind",
    "make_model",
]
