"""The plain reference of the serving path's page accounting.

What the configuration's paged server promises, as a plain model: a
continuous-batching scheduler that admits queued requests first in,
first out up to ``max_batch``; a prompt takes one page per
``page_tokens`` tokens, and with prefix sharing a page whose prompt
prefix (tokens up to the page's end) is already held is shared instead
of allocated; each decode step needs a slot for the newest token, a new
page at a page boundary, and a write into a page that is shared or held
by the prefix index copies it first (copy on write); a finished request
frees its pages, and a page returns to the pool when its last holder
frees it.  The model replays the harness's own log of submissions and
steps and counts allocations, frees, prefix hits and copies.
"""

from __future__ import annotations


class _Page:
    __slots__ = ("refs", "key")

    def __init__(self, key):
        self.refs = 1
        self.key = key


class PagingModel:
    def __init__(self, max_batch: int, page_tokens: int, prefix_share: bool):
        self.max_batch = max_batch
        self.pt = page_tokens
        self.share = prefix_share
        self.pages: dict[int, _Page] = {}
        self.index: dict = {}
        self.next_id = 0
        self.queue: list = []
        self.active: list = []
        self.stats = {"alloc": 0, "free": 0, "prefix_hits": 0, "cow": 0}

    def _alloc(self, key=None) -> int:
        if key is not None and key in self.index:
            pid = self.index[key]
            self.pages[pid].refs += 1
            self.stats["prefix_hits"] += 1
            return pid
        pid = self.next_id
        self.next_id += 1
        self.pages[pid] = _Page(key)
        if key is not None:
            self.index[key] = pid
        self.stats["alloc"] += 1
        return pid

    def _free(self, pid: int) -> None:
        page = self.pages[pid]
        page.refs -= 1
        if page.refs <= 0:
            if page.key is not None and self.index.get(page.key) == pid:
                del self.index[page.key]
            del self.pages[pid]
            self.stats["free"] += 1

    def _write(self, pid: int) -> int:
        page = self.pages[pid]
        indexed = page.key is not None and self.index.get(page.key) == pid
        if page.refs > 1 or indexed:
            new = self._alloc(None)
            self.stats["cow"] += 1
            self._free(pid)
            return new
        return pid

    def submit(self, prompt, max_new: int) -> None:
        self.queue.append({"prompt": bytes(prompt), "n": len(prompt) // 4,
                           "max_new": max_new, "pages": [], "made": 0})

    def step(self) -> None:
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue.pop(0)
            for start in range(0, req["n"], self.pt):
                end = min(start + self.pt, req["n"])
                key = ((req["prompt"][:4 * end], end - start)
                       if self.share else None)
                req["pages"].append(self._alloc(key))
            req["made"] = 1
            self.active.append(req)
        still = []
        for req in self.active:
            idx = (req["n"] + req["made"] - 1) // self.pt
            if idx >= len(req["pages"]):
                req["pages"].append(self._alloc(None))
            else:
                req["pages"][idx] = self._write(req["pages"][idx])
        for req in self.active:
            req["made"] += 1
            if req["made"] >= req["max_new"]:
                for pid in req["pages"]:
                    self._free(pid)
            else:
                still.append(req)
        self.active = still

    @property
    def pages_in_use(self) -> int:
        return len(self.pages)
