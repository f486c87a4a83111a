"""Prompt pages served from a page already held (the MIND pool's
``prefix_hits`` over the window) as a share of the prompt pages that the
requests admitted in the window asked for."""


def read(run):
    if not run.get("prompt_pages"):
        return None
    return 100.0 * run["prefix_hits"] / run["prompt_pages"]
