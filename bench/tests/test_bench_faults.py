"""Whole runs of the tiny cells with the timed path broken underneath:
``correct`` has to come out false for each fault the cell can have.  (No
cell exchanges anything between chips, so that fault has no case.)"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.memory.paged_pool import PagedKVPool
from repro_torch.serving.engine import PagedServer


def _lane_state_unchanged(inner):
    """Stage 3 returns its directory rows and cache planes unchanged."""
    def lane(*args, **kw):
        _, _, w1, w2, w3 = inner(*args, **kw)
        return args[10].clone(), args[12].clone(), w1, w2, w3
    return lane


def _lane_half_the_lanes(inner):
    """Stage 3 replays the first half of the lanes and leaves the rest
    as they were, with no output words."""
    def lane(*args, **kw):
        d, p, w1, w2, w3 = inner(*args, **kw)
        h = (w1.shape[0] + 1) // 2
        d, p = d.clone(), p.clone()
        d[h:], p[h:] = args[10][h:], args[12][h:]
        for w in (w1, w2, w3):
            w[h:] = 0
        return d, p, w1, w2, w3
    return lane


def _protect_altered(inner):
    """Stages 1-2 deny the first access that they should allow."""
    def protect(*args, **kw):
        allow = inner(*args, **kw).clone()
        allow[0] = ~allow[0]
        return allow
    return protect


@pytest.mark.parametrize("name,fault", [
    ("lane_replay", _lane_state_unchanged),
    ("lane_replay", _lane_half_the_lanes),
    ("protect_check", _protect_altered)],
    ids=["state-unchanged", "half-the-batch", "answer-altered"])
def test_replay_fault_is_not_correct(run_tiny, monkeypatch, name, fault):
    monkeypatch.setattr(ops, name, fault(getattr(ops, name)))
    line = run_tiny("tiny.replay")
    assert line["correct"] is False


def _kv_never_written(self, pid, offset, k, v):
    """The prefill's K/V never reach their pages: the cache keeps its
    state."""


def _never_shared(inner):
    """The pool allocates every prompt page anew: prefix sharing, one of
    the paging guarantees, broken where the answer is produced."""
    def alloc(self, session, replica=0, prefix_key=None):
        return inner(self, session, replica, prefix_key=None)
    return alloc


def _decode_half_the_batch(inner):
    """The decode step computes the first half of the batch and gives the
    rest the first half's logits."""
    def decode(self, params, kp, vp, tokens, lengths, bt):
        h = (tokens.shape[0] + 1) // 2
        logits, kp, vp = inner(self, params, kp, vp, tokens[:h],
                               lengths[:h], bt[:h])
        idx = torch.arange(tokens.shape[0], device=logits.device) % h
        return logits[idx], kp, vp
    return decode


def _decode_token_altered(inner):
    """The decode step's token is the least likely one."""
    def decode(self, *args):
        logits, kp, vp = inner(self, *args)
        return -logits, kp, vp
    return decode


@pytest.mark.parametrize("target,name,fault", [
    (PagedKVPool, "write_tokens", lambda inner: _kv_never_written),
    (PagedKVPool, "alloc_page", _never_shared),
    (PagedServer, "_decode_fn", _decode_half_the_batch),
    (PagedServer, "_decode_fn", _decode_token_altered)],
    ids=["state-unchanged", "pages-never-shared", "half-the-batch",
         "token-altered"])
def test_serve_fault_is_not_correct(run_tiny, monkeypatch, target, name,
                                    fault):
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    line = run_tiny("tiny.serve")
    assert line["correct"] is False
    if name == "alloc_page":
        assert line["checks"]["paging_counts_differing"]["value"] > 0
