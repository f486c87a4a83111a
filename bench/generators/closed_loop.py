"""Chat requests from a closed loop of clients (traffic ``kind``
``closed_loop``).

Each of ``clients`` clients has one request in flight and sends its next
when the last finishes.  A request is a shared system prompt of
``shared_prefix_tokens``, then a unique suffix of ``private_prefix_tokens``
plus a drawn length, and asks for a drawn output length; the drawn
lengths are lognormal (median, sigma) clipped to [min, max].  Each is a
fixed set of ``length_set`` lengths, the distribution's quantiles at
(i + 1/2) / length_set, dealt out cycle after cycle, each cycle in an
order drawn from ``--seed``: every seed serves the same sizes.  Every
``repeat_every``-th request repeats the prompt of the newest request of
another client still in flight (its partial tail page is then shared and
copied on write).  Token ids are uniform over the vocabulary.

A request source (``FORM = "requests"``) gives the serve driver
``(tag, prompt int32 [S], max_new)`` triples: ``start(now)`` the first,
``finished(tag, now)`` those sent when the request ``tag`` finishes,
``due(now)`` those whose arrival time has come, and ``next_at()`` the
time of the next arrival while nothing is in flight (None: never).
``warm`` requests finish in set-up before the window opens.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

FORM = "requests"


def lengths(spec: dict, n: int) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


class Source:
    def __init__(self, mix: dict, vocab: int, seed: int):
        k = int(mix["length_set"])
        self.suffix = lengths(mix["suffix_tokens"], k)
        self.output = lengths(mix["output_tokens"], k)
        self.rng = np.random.default_rng(seed)
        self.cycle: list = []
        self.vocab = vocab
        self.prefix = self.rng.integers(
            0, vocab, int(mix["shared_prefix_tokens"])).astype(np.int32)
        self.private = int(mix.get("private_prefix_tokens", 0))
        self.repeat_every = int(mix.get("repeat_every", 0))
        self.clients = int(mix["clients"])
        self.warm = self.clients
        self.count = 0
        self.in_flight: dict[int, np.ndarray] = {}  # client -> prompt, oldest first

    def _next(self, client: int) -> tuple:
        if not self.cycle:
            k = len(self.suffix)
            self.cycle = list(zip(self.rng.permutation(k),
                                  self.rng.permutation(k)))
        i, j = self.cycle.pop()
        self.count += 1
        n_out = int(self.output[j])
        others = [p for c, p in self.in_flight.items() if c != client]
        if self.repeat_every and self.count % self.repeat_every == 0 and others:
            prompt = others[-1].copy()
        else:
            suffix = self.rng.integers(0, self.vocab,
                                       self.private + int(self.suffix[i]))
            prompt = np.concatenate([self.prefix, suffix.astype(np.int32)])
        self.in_flight[client] = prompt
        return client, prompt, n_out

    def start(self, now: float) -> list:
        return [self._next(c) for c in range(self.clients)]

    def finished(self, tag: int, now: float) -> list:
        del self.in_flight[tag]
        return [self._next(tag)]

    def due(self, now: float) -> list:
        return []

    def next_at(self):
        return None
