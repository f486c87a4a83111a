"""Seconds of the replay engine's host passes per million accesses: every
``PHASES`` entry of ``dataplane/engine.py``'s ``phase_times`` but the two
that hold the device's work (``device``, ``stage12_tcam``), summed over
the window's replays."""


def read(run):
    if "phase_s" not in run or not run["accesses"]:
        return None
    host = sum(v for k, v in run["phase_s"].items()
               if k not in run["device_phases"])
    return host / (run["accesses"] / 1e6)
