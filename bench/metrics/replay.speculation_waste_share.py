"""Epoch speculation's waste: the accesses the replay engine replayed in
speculative chunks it then discarded, as a share of every access it
replayed (the program's counters ``accesses_discarded`` and
``accesses_replayed``, summed over the window's replays)."""


def read(run):
    c = getattr(run.get("program"), "counters", None)
    if not c or not c.get("accesses_replayed"):
        return None
    return 100.0 * c.get("accesses_discarded", 0) / c["accesses_replayed"]
