"""Coherence invariant checker: replay the flight-recorder stream.

The flight recorder captures everything the coherence protocol *did*;
this module re-derives what it was *allowed* to do.  A shadow MSI state
machine is folded over the event stream (grouped by access index, in
canonical order) and every departure from the protocol contract becomes
a :class:`Violation`:

* **state-machine** — an ``access`` event's transition kind claims a
  pre-state (the ``X`` of ``X->Y``) that contradicts the shadow state.
* **hit-from-invalid** — ``hit=1`` on an ``I->*`` transition: a local
  hit out of the Invalid state is a residency lie.
* **residency** — ``hit=1`` from a blade the shadow directory does not
  list as a sharer (S) / the owner (M), when the sharer set is fully
  known.
* **swmr** — single-writer/multiple-reader: taking M from another
  owner (``M->M``/``M->S``) or upgrading past other sharers (``S->M``)
  without the same-index invalidation/downgrade multicast that makes
  the transfer safe.
* **lost-writeback** — an invalidation/downgrade that flushed dirty
  pages without a same-index ``writeback`` event carrying exactly that
  page count (and, in MSI streams, any orphan ``writeback``).
* **fault-sequence** — ``blade_kill`` of an already-dead blade,
  ``blade_restore`` of a live one, or a ``remap`` whose source blade
  was not killed at that index.

The shadow is deliberately conservative: region knowledge resets to
*unknown* whenever the directory reshapes it (``dir_install``,
``dir_evict``, ``region_split``, ``region_merge``), and unknown regions
admit any transition — the checker never reports a violation it cannot
prove from the stream alone.  Both engines' streams are checked by the
parity suite; a corrupted stream (the pinned negative test) is caught.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import groupby

from . import events as ev
from .events import canonical

#: ACCESS transition kinds the shadow machine understands.
_MSI_KINDS = frozenset(
    {"I->S", "I->M", "S->S", "S->M", "M->M", "M->S"})


class CoherenceInvariantError(AssertionError):
    """Raised by :func:`check_invariants` (``strict=True``) when the
    stream violates the protocol contract; carries the violations."""

    def __init__(self, violations):
        self.violations = list(violations)
        head = "; ".join(str(v) for v in self.violations[:5])
        more = len(self.violations) - 5
        if more > 0:
            head += f"; ... {more} more"
        super().__init__(
            f"{len(self.violations)} coherence invariant violation(s): "
            f"{head}")


@dataclass(frozen=True)
class Violation:
    index: int   # trace access index the offending event carries
    rule: str    # one of the rule names in the module docstring
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}@{self.index}] {self.message}"


class _Region:
    """Shadow directory entry: ``state`` is "I"/"S"/"M" or ``None``
    (unknown); ``complete`` marks a sharer set derived from a known-I
    origin, i.e. one the residency rules may trust exhaustively."""

    __slots__ = ("log2", "state", "owner", "sharers", "complete")

    def __init__(self, log2: int):
        self.log2 = log2
        self.state: str | None = None
        self.owner: int | None = None
        self.sharers: set[int] = set()
        self.complete = False


def _events_of(source):
    if hasattr(source, "recorder"):   # a Telemetry
        return list(source.recorder.events)
    if hasattr(source, "events"):     # a FlightRecorder
        return list(source.events)
    return list(source)


def check_invariants(source, strict: bool = False) -> list[Violation]:
    """Check the coherence invariants over ``source`` — a
    :class:`~repro_torch.telemetry.Telemetry`, a flight recorder, or any
    iterable of :class:`~repro_torch.telemetry.events.Event`.

    Returns the violations found (empty list = clean stream); with
    ``strict=True`` raises :class:`CoherenceInvariantError` instead of
    returning a non-empty list.
    """
    events = canonical(_events_of(source))
    out: list[Violation] = []
    shadow: dict[int, _Region] = {}
    dead: set[int] = set()
    # Streams from the software baselines (gam/fastswap) use their own
    # access kinds; MSI-specific rules only arm for in-network streams.
    msi_stream = any(e.kind == ev.ACCESS and e.tkind in _MSI_KINDS
                     for e in events)

    def drop_overlapping(base: int, log2: int) -> None:
        lo, hi = base, base + (1 << log2)
        for b in [b for b, r in shadow.items()
                  if b < hi and lo < b + (1 << r.log2)]:
            del shadow[b]

    for index, grp in groupby(events, key=lambda e: e.index):
        group = list(grp)
        invs = [e for e in group
                if e.kind in (ev.INVALIDATE, ev.DOWNGRADE)]
        wbs = [e for e in group if e.kind == ev.WRITEBACK]

        for e in group:
            k = e.kind
            if k == ev.ACCESS:
                if e.fault or e.tkind not in _MSI_KINDS:
                    continue
                pre, post = e.tkind.split("->")
                sh = shadow.get(e.base)
                if sh is not None and sh.log2 != e.log2:
                    # The directory reshaped this region without an
                    # observed split/merge (ring truncation): forget it.
                    sh = None
                    drop_overlapping(e.base, e.log2)
                if sh is not None and sh.state is not None \
                        and sh.state != pre:
                    out.append(Violation(
                        index, "state-machine",
                        f"access at region {e.base:#x} claims pre-state "
                        f"{pre} but the shadow directory holds "
                        f"{sh.state}"))
                if e.hit == 1 and pre == "I":
                    out.append(Violation(
                        index, "hit-from-invalid",
                        f"blade {e.blade} reports a local hit on region "
                        f"{e.base:#x} while transitioning out of I — "
                        "no copy can be resident in Invalid state"))
                elif e.hit == 1 and sh is not None:
                    if pre == "S" and sh.complete \
                            and e.blade not in sh.sharers:
                        out.append(Violation(
                            index, "residency",
                            f"blade {e.blade} hit S-state region "
                            f"{e.base:#x} but the sharer set is "
                            f"{sorted(sh.sharers)}"))
                    elif pre == "M" and sh.owner is not None \
                            and e.blade != sh.owner:
                        out.append(Violation(
                            index, "residency",
                            f"blade {e.blade} hit M-state region "
                            f"{e.base:#x} owned by blade {sh.owner}"))
                base_invs = [i for i in invs if i.base == e.base]
                if sh is not None and pre == "M" \
                        and sh.owner is not None \
                        and sh.owner != e.blade and not base_invs:
                    out.append(Violation(
                        index, "swmr",
                        f"blade {e.blade} took region {e.base:#x} from "
                        f"owner {sh.owner} ({e.tkind}) with no "
                        "invalidation/downgrade at this index"))
                if sh is not None and pre == "S" and post == "M" \
                        and sh.complete and (sh.sharers - {e.blade}) \
                        and not base_invs:
                    out.append(Violation(
                        index, "swmr",
                        f"blade {e.blade} upgraded region {e.base:#x} "
                        f"to M past sharers "
                        f"{sorted(sh.sharers - {e.blade})} with no "
                        "invalidation at this index"))
                # Fold the transition into the shadow.
                old_owner = sh.owner if sh is not None else None
                was_known = sh is not None and sh.state is not None
                if sh is None:
                    sh = shadow[e.base] = _Region(e.log2)
                if post == "M":
                    # M is exclusive by definition: the sharer set is
                    # fully known no matter what we knew before.
                    sh.state, sh.owner = "M", e.blade
                    sh.sharers = set()
                    sh.complete = True
                elif pre == "I":  # I->S: nobody held it before
                    sh.state, sh.owner = "S", None
                    sh.sharers = {e.blade}
                    sh.complete = True
                elif pre == "M":  # M->S: downgrade keeps the old copy
                    sh.state, sh.owner = "S", None
                    sh.sharers = {e.blade}
                    if old_owner is not None and any(
                            i.kind == ev.DOWNGRADE for i in base_invs):
                        sh.sharers.add(old_owner)
                    sh.complete = was_known and sh.complete
                else:  # S->S
                    sh.state = "S"
                    sh.sharers.add(e.blade)
            elif k in (ev.DIR_INSTALL, ev.DIR_EVICT, ev.REGION_SPLIT,
                       ev.REGION_MERGE):
                drop_overlapping(e.base, e.log2)
            elif k == ev.BLADE_KILL:
                if e.blade in dead:
                    out.append(Violation(
                        index, "fault-sequence",
                        f"blade_kill of blade {e.blade} which is "
                        "already dead"))
                dead.add(e.blade)
            elif k == ev.BLADE_RESTORE:
                if e.blade not in dead:
                    out.append(Violation(
                        index, "fault-sequence",
                        f"blade_restore of blade {e.blade} which is "
                        "alive"))
                dead.discard(e.blade)
            elif k == ev.REMAP:
                if e.targets not in dead and not any(
                        g.kind == ev.BLADE_KILL and g.blade == e.targets
                        for g in group):
                    out.append(Violation(
                        index, "fault-sequence",
                        f"remap away from blade {e.targets} which was "
                        "never killed"))

        # No-lost-writebacks: per (base, log2) at this index, the dirty
        # pages the invalidation multicasts flushed must land in
        # writeback events, page for page.
        if msi_stream and (invs or wbs):
            keys = {(e.base, e.log2) for e in invs + wbs}
            for base, log2 in sorted(keys):
                flushed = sum(e.flushed for e in invs
                              if (e.base, e.log2) == (base, log2))
                written = sum(e.pages for e in wbs
                              if (e.base, e.log2) == (base, log2))
                if flushed != written:
                    out.append(Violation(
                        index, "lost-writeback",
                        f"region {base:#x}: invalidations flushed "
                        f"{flushed} dirty page(s) but writeback events "
                        f"carry {written}"))

    if strict and out:
        raise CoherenceInvariantError(out)
    return out
