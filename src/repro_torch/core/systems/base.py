"""The per-system model interface the rack dispatches through.

One :class:`SystemModel` subclass per compared system (§7.1): the model
owns everything that used to be ``if self.system == ...`` branches in
:class:`~repro_torch.core.emulator.DisaggregatedRack` — the per-access scalar
step, the system's private state (the in-network MMU for mind*, the
software-DSM page directory and blade caches for GAM, the per-blade
swap caches for FastSwap), the PSO flag, its epoch behaviour, and which
batched replay engine realizes it.  ``_run_scalar`` and ``ShardedRack``
consult the model (``model.scalar_access``, ``model.has_switch``)
instead of branching on the system name.
"""

from __future__ import annotations


class SystemModel:
    """Behavioural model of one compared system, bound to one rack.

    Subclasses set the class-level capability flags and implement
    :meth:`scalar_access` (the per-access oracle step) and
    :meth:`make_batched_engine` (the vectorized replay of the same
    semantics).  ``stats`` is the live
    :class:`~repro_torch.core.types.EpochStats` the run reports.
    """

    #: canonical system name ("mind", "gam", ...)
    name: str = ""
    #: writes retire asynchronously into a write buffer (PSO ordering)
    pso: bool = False
    #: an in-network MMU exists — the system can be sharded across
    #: switches and runs the Bounded-Splitting epoch machinery
    has_switch: bool = False

    def __init__(self, rack):
        self.rack = rack
        self.telemetry = None

    # -- scalar oracle step -------------------------------------------- #
    def scalar_access(self, blade: int, vaddr: int, is_write: bool,
                      breakdown: dict, trans_lat: dict) -> float:
        """Process one access; mutate stats/breakdown; return charged us."""
        raise NotImplementedError

    def on_epoch(self, next_epoch_at: float, clocks, breakdown: dict,
                 dir_timeline: list) -> None:
        """Epoch-boundary side effects (mean thread clock crossed
        ``next_epoch_at``).  Baselines have none: the boundary advances
        with no observable effect, exactly as the pre-model emulator
        skipped the mind-only epoch block for them."""

    # -- state the rack / result assembly reads ------------------------ #
    @property
    def stats(self):
        raise NotImplementedError

    # -- engines ------------------------------------------------------- #
    def make_batched_engine(self, **engine_options):
        """Return the batched replay engine for this system (an object
        with ``run(trace, max_accesses)`` returning an
        :class:`~repro_torch.core.emulator.EmulationResult`)."""
        raise NotImplementedError

    # -- telemetry ----------------------------------------------------- #
    def wire_telemetry(self, tel) -> None:
        """Attach an *enabled* Telemetry to the model's components.
        Only called with a live plane — the zero-overhead-when-disabled
        contract keeps every ``telemetry`` attribute None otherwise."""
        self.telemetry = tel
