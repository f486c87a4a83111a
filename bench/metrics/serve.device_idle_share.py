"""The share of the traced serving window in which no operation ran on
the device."""


def read(run):
    if "decode_steps" not in run or not run["window_s"] or not run["busy_s"]:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
