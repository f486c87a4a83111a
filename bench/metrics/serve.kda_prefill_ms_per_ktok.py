"""The prefill's Kimi Delta Attention layers (``models/kda.py``'s chunked
recurrence and its projections): the program's ``prefill.kda`` spans of
the window, summed, per 1,000 prompt tokens prefilled in the window (host
clock; the spans time the host's enqueue and whatever it waits on)."""


def read(run):
    rec, tokens = run.get("program"), run.get("prefill_tokens")
    if rec is None or not tokens:
        return None
    spans = rec.spans("prefill.kda")
    if not spans:
        return None
    return sum(e - s for _, s, e in spans) * 1e3 / (tokens / 1000.0)
