"""The slot-grouped MSI algorithm (plain model, on the CPU) vs the JAX package.

``repro_torch.kernels.directory_msi.msi_transition_grouped_plain`` is the
algorithm of the CUDA ``msi_transition``: the requests are grouped by their
clamped slot with a stable sort, and each slot's chain is walked in batch
order.  It is held bytewise to the packet-order plain version, to the Pallas
kernel in interpret mode (``repro.kernels.ops.msi_transition``) and to the
NumPy oracle ``repro.kernels.ref.msi_transition_ref`` on the cases of
``tests/test_torch_directory_msi.py`` and on a zipf(1.1) hot-slot stream.
Where a reference has a blind spot (requester 31 in the oracle, B = 0 in
the Pallas kernel), the case is held to the other one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R

from repro_torch.kernels.directory_msi import (
    msi_transition_grouped_plain,
    msi_transition_plain,
)


def random_directory(rng, s, nblades=4):
    """``tests/test_kernels.py``'s ``_random_directory``."""
    state = rng.integers(0, 3, s).astype(np.int32)
    owner = np.where(state == 2, rng.integers(0, nblades, s), -1).astype(np.int32)
    sharers = np.where(
        state == 2, 1 << np.maximum(owner, 0),
        np.where(state == 1, rng.integers(1, 1 << nblades, s), 0),
    ).astype(np.int32)
    return state, sharers, owner


def i32(*arrays):
    return [np.asarray(a, np.int32) for a in arrays]


def grouped(*args):
    out = msi_transition_grouped_plain(*(torch.from_numpy(a) for a in i32(*args)))
    return [o.numpy() for o in out]


def sequential(*args):
    out = msi_transition_plain(*(torch.from_numpy(a) for a in i32(*args)))
    return [o.numpy() for o in out]


def pallas(*args):
    return [np.asarray(o) for o in K.msi_transition(*(jnp.asarray(a)
                                                      for a in i32(*args)))]


def assert_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def zipf_slots(rng, s, b, a=1.1):
    p = 1.0 / np.arange(1, s + 1) ** a
    return rng.permutation(s)[rng.choice(s, b, p=p / p.sum())]


@pytest.mark.parametrize("s,b", [(16, 40), (128, 500)])
def test_grouped_matches_pallas_and_ref_on_the_sweep(s, b):
    rng = np.random.default_rng(s + b)
    args = (*random_directory(rng, s), rng.integers(0, s, b),
            rng.integers(0, 4, b), rng.integers(0, 2, b))
    got = grouped(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))
    assert_equal(got, sequential(*args))


def test_grouped_hot_slot_runs():
    rng = np.random.default_rng(5)
    s, b = 64, 400
    slots = np.where(rng.random(b) < 0.8, 7, rng.integers(0, s, b))
    slots[100:250] = 7  # one unbroken run
    args = (*random_directory(rng, s, nblades=8), slots,
            rng.integers(0, 8, b), (rng.random(b) < 0.5).astype(np.int32))
    got = grouped(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))


def test_grouped_zipf_hot_slot_stream():
    """MIND's traffic shape: zipf(1.1) slots, so one chain holds a large
    share of the batch and most slots see one or two requests."""
    rng = np.random.default_rng(11)
    s, b = 3000, 1500
    slots = zipf_slots(rng, s, b)
    counts = np.bincount(slots, minlength=s)
    assert counts.max() > b // 10 and (counts == 1).sum() > 100
    args = (np.zeros(s), np.zeros(s), np.full(s, -1), slots,
            rng.integers(0, 8, b), rng.random(b) < 0.5)
    got = grouped(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, sequential(*args))


def test_grouped_requester_31_sign_bit():
    """``1 << 31`` wraps to INT32_MIN; the NumPy oracle overflows on it, so
    the Pallas kernel alone is the reference."""
    rng = np.random.default_rng(6)
    s, b = 16, 200
    args = (*random_directory(rng, s), rng.integers(0, s, b),
            np.where(rng.random(b) < 0.5, 31, rng.integers(0, 31, b)),
            rng.integers(0, 2, b))
    got = grouped(*args)
    assert (got[1] < 0).any()
    assert_equal(got, pallas(*args))


def test_grouped_owner_flush_chains():
    rng = np.random.default_rng(7)
    s, b = 32, 300
    owner = rng.integers(0, 8, s)
    args = (np.full(s, 2), 1 << owner, owner, rng.integers(0, 4, b),
            rng.integers(0, 8, b), rng.integers(0, 2, b))
    got = grouped(*args)
    assert (got[3] >= 0).sum() > b // 3
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))


@pytest.mark.parametrize("seed", [8, 9])
def test_grouped_out_of_range_slots_states_and_requesters(seed):
    """Slots past either end group with the slot they clamp to (a negative
    one counts from the end once); states outside {I, S, M}, is_write 2 and
    requesters outside [0, 31] follow XLA's index and shift rules."""
    rng = np.random.default_rng(seed)
    s, b = 12, 300
    args = (rng.integers(-3, 6, s), rng.integers(-(1 << 31), 1 << 31, s),
            rng.integers(-3, 40, s), rng.integers(-3 * s, 3 * s, b),
            rng.integers(-40, 40, b), rng.integers(0, 3, b))
    got = grouped(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, sequential(*args))


def test_grouped_single_slot_and_single_request():
    rng = np.random.default_rng(12)
    one_slot = (*random_directory(rng, 1), rng.integers(-2, 3, 60),
                rng.integers(0, 4, 60), rng.integers(0, 2, 60))
    assert_equal(grouped(*one_slot), pallas(*one_slot))
    one_request = (*random_directory(rng, 64), [70], [3], [1])
    assert_equal(grouped(*one_request), pallas(*one_request))


def test_grouped_empty_batch():
    """The Pallas kernel cannot be traced at B = 0; the oracle can."""
    rng = np.random.default_rng(4)
    directory = random_directory(rng, 8)
    empty = np.zeros(0, np.int32)
    got = grouped(*directory, empty, empty, empty)
    assert_equal(got, R.msi_transition_ref(*directory, empty, empty, empty))
