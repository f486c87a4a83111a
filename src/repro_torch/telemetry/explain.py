"""Parity-diff explainer: pinpoint the first divergent coherence event.

``first_divergence`` compares two flight-recorder streams (typically the
scalar oracle vs the batched reconstruction) as per-access-index
multisets of canonical events, and names the first trace access index
where they disagree — plus the context around it — so a stats mismatch
stops being "counters differ" and becomes "access #417 invalidated 3
pages on one engine and 2 on the other".

Usage on a parity failure::

    from repro_torch.telemetry import explain
    report = explain.first_divergence(rs.telemetry.recorder.events,
                                      rb.telemetry.recorder.events)
    print(explain.render(report))

``assert_event_parity`` wraps this for tests: it raises with the
rendered report on the first divergence and additionally checks the
charged microseconds of matching ``access`` events within a tolerance.
"""

from __future__ import annotations

import math

from .events import canonical


def _by_index(events):
    groups = {}
    for e in canonical(events):
        groups.setdefault(e.index, []).append(e)
    return groups


def _fmt(e) -> str:
    parts = [f"{e.kind}"]
    if e.blade >= 0:
        parts.append(f"blade={e.blade}")
    parts.append(f"base={e.base:#x}/{e.log2}")
    for f in ("targets", "pages", "flushed", "false_pages", "fault"):
        v = getattr(e, f)
        if v:
            parts.append(f"{f}={v}")
    if e.write >= 0:
        parts.append(f"write={e.write}")
    if e.hit >= 0:
        parts.append(f"hit={e.hit}")
    if e.tkind:
        parts.append(e.tkind)
    if e.us:
        parts.append(f"us={e.us:.3f}")
    return " ".join(parts)


def first_divergence(events_a, events_b, names=("scalar", "batched"),
                     us_rtol=1e-6, context=3):
    """Return None if the streams agree, else a divergence report dict.

    Events are grouped by trace access index and compared as sorted
    multisets of :meth:`Event.key` (every integer field); ``us`` is
    compared separately with a relative tolerance on key-matched pairs.
    """
    ga, gb = _by_index(events_a), _by_index(events_b)
    for idx in sorted(set(ga) | set(gb)):
        ea, eb = ga.get(idx, []), gb.get(idx, [])
        keys_a = [e.key() for e in ea]
        keys_b = [e.key() for e in eb]
        mismatch = None
        if keys_a != keys_b:
            only_a = [e for e in ea if keys_b.count(e.key()) <
                      keys_a.count(e.key())]
            only_b = [e for e in eb if keys_a.count(e.key()) <
                      keys_b.count(e.key())]
            mismatch = ("events", only_a, only_b)
        else:
            for x, y in zip(ea, eb):
                if not math.isclose(x.us, y.us, rel_tol=us_rtol,
                                    abs_tol=1e-9):
                    mismatch = ("latency", [x], [y])
                    break
        if mismatch is None:
            continue
        what, only_a, only_b = mismatch
        ctx_idx = [i for i in sorted(set(ga) | set(gb))
                   if 0 <= idx - i <= context]
        return {
            "index": idx,
            "kind": what,
            "names": names,
            "only_a": only_a,
            "only_b": only_b,
            "context_a": [e for i in ctx_idx for e in ga.get(i, [])],
            "context_b": [e for i in ctx_idx for e in gb.get(i, [])],
        }
    return None


def render(report) -> str:
    if report is None:
        return "event streams agree"
    na, nb = report["names"]
    lines = [f"first divergence at trace access index {report['index']} "
             f"({report['kind']} mismatch)"]
    for side, only, ctx in ((na, report["only_a"], report["context_a"]),
                            (nb, report["only_b"], report["context_b"])):
        lines.append(f"-- {side}: divergent events --")
        lines += [f"   {_fmt(e)}" for e in only] or ["   (none)"]
        lines.append(f"-- {side}: context (up to the divergence) --")
        lines += [f"   [{e.index}] {_fmt(e)}" for e in ctx]
    return "\n".join(lines)


def assert_event_parity(tel_a, tel_b, names=("scalar", "batched"),
                        us_rtol=1e-6) -> None:
    report = first_divergence(tel_a.recorder.events, tel_b.recorder.events,
                              names=names, us_rtol=us_rtol)
    if report is not None:
        raise AssertionError(render(report))


#: Metric series legitimately emitted by only one engine: the batched
#: engine's speculative-execution machinery has no scalar counterpart
#: (its events are NON_PARITY_KINDS; this is the counter-side twin).
NON_PARITY_COUNTERS = frozenset({"speculation_rollbacks_total"})


def assert_metric_parity(tel_a, tel_b, names=("scalar", "batched")) -> None:
    """Exact equality of counters and histogram bins across two runs,
    minus the engine-private :data:`NON_PARITY_COUNTERS` series."""
    na, nb = names
    ca = {k: v for k, v in tel_a.metrics._counters.items()
          if k[0] not in NON_PARITY_COUNTERS}
    cb = {k: v for k, v in tel_b.metrics._counters.items()
          if k[0] not in NON_PARITY_COUNTERS}
    if ca != cb:
        diffs = [f"  {k}: {na}={ca.get(k)} {nb}={cb.get(k)}"
                 for k in sorted(set(ca) | set(cb), key=repr)
                 if ca.get(k) != cb.get(k)]
        raise AssertionError("counter mismatch:\n" + "\n".join(diffs))
    ha, hb = tel_a.metrics._hists, tel_b.metrics._hists
    if set(ha) != set(hb):
        raise AssertionError(f"histogram series differ: "
                             f"{sorted(set(ha) ^ set(hb), key=repr)}")
    for k in ha:
        if (ha[k].counts != hb[k].counts).any():
            raise AssertionError(f"histogram bins differ for {k}")
