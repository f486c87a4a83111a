"""Per-system model layer: one :class:`SystemModel` per compared system.

The rack (:class:`~repro_torch.core.emulator.DisaggregatedRack`) builds a
model with :func:`make_model` and dispatches every per-access step, epoch
boundary, telemetry wiring and batched-engine construction through it.

=============  =======================  ====================================
system         model                    batched engine
=============  =======================  ====================================
``mind``       :class:`MindModel`       ``repro_torch.dataplane.engine``
``mind-pso``   :class:`MindModel`       (CUDA TCAM + MSI wave kernels)
``mind-pso+``  :class:`MindModel`
=============  =======================  ====================================

``gam`` and ``fastswap`` are not ported yet: they arrive with the
baselines slice of the port (ROADMAP Queue A5), and asking for them
raises ``ValueError``.
"""

from __future__ import annotations

from repro_torch.core.systems.base import SystemModel
from repro_torch.core.systems.mind import MindModel

#: Every system name the rack accepts.
SYSTEMS = ("mind", "mind-pso", "mind-pso+", "gam", "fastswap")

#: The systems this package can build so far.
PORTED_SYSTEMS = ("mind", "mind-pso", "mind-pso+")


def make_model(system: str, rack) -> SystemModel:
    """Build the model for ``system``, bound to ``rack``."""
    if system.startswith("mind"):
        return MindModel(rack, name=system)
    if system in ("gam", "fastswap"):
        raise ValueError(
            f"system {system!r} is not ported to repro_torch yet: the gam "
            f"and fastswap models and their batched replays come with the "
            f"baselines slice (ROADMAP Queue A5); ported: {PORTED_SYSTEMS}")
    raise ValueError(f"unknown system {system!r}; expected one of {SYSTEMS}")


__all__ = [
    "PORTED_SYSTEMS",
    "SYSTEMS",
    "SystemModel",
    "MindModel",
    "make_model",
]
