"""Stage 3's uploads: host seconds of the program's ``device.upload``
spans (``lane_inputs_to_device``, pageable copies of each launch's
inputs; discarded speculative chunks' ``discarded.device.upload`` too)
per million accesses replayed in the window."""


def read(run):
    rec = run.get("program")
    if rec is None or not run.get("accesses"):
        return None
    up = [e - s for n, s, e in rec.spans() if n.endswith("device.upload")]
    return sum(up) / (run["accesses"] / 1e6) if up else None
