"""The 95th percentile of time to first token: the program's stamp of a
request's first token (the end of the ``step()`` that handed it out)
less its submission, over the requests submitted and answered in the
window (at least 20)."""

import math
import statistics


def read(run):
    rec = run.get("program")
    if rec is None:
        return None
    ttft = [s.token_t[0] - s.submit_t for s in rec.requests.values()
            if not math.isnan(s.submit_t) and s.token_t]
    if len(ttft) < 20:
        return None
    return statistics.quantiles(ttft, n=20)[-1] * 1e3
