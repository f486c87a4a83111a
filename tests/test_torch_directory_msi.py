"""repro_torch MSI directory transitions (plain versions, on the CPU) vs the JAX package.

``ops.msi_transition`` on CPU tensors (which takes ``msi_transition_plain``)
is held bytewise to the Pallas kernel run in interpret mode
(``repro.kernels.ops.msi_transition``) and to the NumPy oracle
``repro.kernels.ref.msi_transition_ref``, over the sweep of
``tests/test_kernels.py`` (its ``_random_directory`` construction) and
extra cases: an empty batch (against the oracle alone: the Pallas kernel
cannot be traced at B = 0), long runs of one hot slot, requester 31 (the
sign bit; against the Pallas kernel alone: the oracle overflows), an all-M
directory with owner-flush chains, and out-of-range slots, states and
requesters, where both follow XLA's index and shift rules.  ``msi_transition_vectorized`` is held to the JAX variant on
distinct slots, in range and out of it, and the transition table to the JAX one.  The CUDA kernel
is held to the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.kernels.directory_msi import (
    build_transition_table as jax_transition_table,
)

from repro_torch.kernels import ops as P
from repro_torch.kernels.directory_msi import msi_transition_plain


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


def port(*args):
    out = P.msi_transition(*(torch.from_numpy(a) for a in i32(*args)))
    return [o.numpy() for o in out]


def port_vectorized(*args):
    out = P.msi_transition_vectorized(*(torch.from_numpy(a)
                                        for a in i32(*args)))
    return [o.numpy() for o in out]


def pallas(*args):
    return [np.asarray(o) for o in K.msi_transition(*(jnp.asarray(a)
                                                      for a in i32(*args)))]


def assert_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s,b", [(16, 40), (128, 500)])
def test_sequential_matches_pallas_and_ref(s, b):
    rng = np.random.default_rng(s + b)
    state, sharers, owner = random_directory(rng, s)
    slots = rng.integers(0, s, b)
    req = rng.integers(0, 4, b)
    w = rng.integers(0, 2, b)
    args = (state, sharers, owner, slots, req, w)
    got = port(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))


def test_inputs_are_left_as_they_are():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in i32(*random_directory(rng, 32),
                                             rng.integers(0, 32, 64),
                                             rng.integers(0, 4, 64),
                                             rng.integers(0, 2, 64))]
    before = [a.clone() for a in args]
    P.msi_transition(*args)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def test_empty_batch():
    rng = np.random.default_rng(4)
    directory = random_directory(rng, 8)
    empty = np.zeros(0, np.int32)
    got = port(*directory, empty, empty, empty)
    # The Pallas kernel cannot be traced at B = 0 (its loop body slices a
    # [0] ref); the oracle can.
    assert_equal(got, R.msi_transition_ref(*directory, empty, empty, empty))
    for g, d in zip(got, directory):
        np.testing.assert_array_equal(g, d)


def test_hot_slot_runs():
    """Long runs on one slot: packet order decides every answer."""
    rng = np.random.default_rng(5)
    s, b = 64, 400
    state, sharers, owner = random_directory(rng, s, nblades=8)
    slots = np.where(rng.random(b) < 0.8, 7, rng.integers(0, s, b))
    slots[100:250] = 7  # one unbroken run
    req = rng.integers(0, 8, b)
    w = (rng.random(b) < 0.5).astype(np.int32)
    args = (state, sharers, owner, slots, req, w)
    got = port(*args)
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))


def test_requester_31_sign_bit():
    """Blade 31's bit is the sign bit: ``1 << 31`` wraps to INT32_MIN.  The
    NumPy oracle cannot hold that bit (it stores ``1 << 31`` into int32 and
    overflows), so the Pallas kernel alone is the reference here."""
    rng = np.random.default_rng(6)
    s, b = 16, 200
    state, sharers, owner = random_directory(rng, s)
    req = np.where(rng.random(b) < 0.5, 31, rng.integers(0, 31, b))
    slots = rng.integers(0, s, b)
    w = rng.integers(0, 2, b)
    args = (state, sharers, owner, slots, req, w)
    got = port(*args)
    assert (got[1] < 0).any() and (got[4] < 0).any()
    assert_equal(got, pallas(*args))


def test_all_modified_owner_flush_chains():
    """Every slot starts in M; reads and writes from other blades flush the
    owner one after the other."""
    rng = np.random.default_rng(7)
    s, b = 32, 300
    owner = rng.integers(0, 8, s)
    state = np.full(s, 2)
    sharers = 1 << owner
    slots = rng.integers(0, 4, b)  # few slots: long chains
    req = rng.integers(0, 8, b)
    w = rng.integers(0, 2, b)
    args = (state, sharers, owner, slots, req, w)
    got = port(*args)
    assert (got[3] >= 0).sum() > b // 3  # many fetches from an owner
    assert_equal(got, pallas(*args))
    assert_equal(got, R.msi_transition_ref(*i32(*args)))


def test_out_of_range_inputs_follow_xla():
    """Slots past either end, states outside {I, S, M}, is_write 2 and
    requesters outside [0, 31]: the table row and the slot are read as jnp
    reads them, shifts as XLA computes them."""
    rng = np.random.default_rng(8)
    s, b = 12, 300
    state = rng.integers(-3, 6, s)
    sharers = rng.integers(-(1 << 31), 1 << 31, s)
    owner = rng.integers(-3, 40, s)
    slots = rng.integers(-2 * s, 2 * s, b)
    req = rng.integers(-40, 40, b)
    w = rng.integers(0, 3, b)
    args = (state, sharers, owner, slots, req, w)
    assert_equal(port(*args), pallas(*args))


@pytest.mark.parametrize("s,n", [(64, 32), (4096, 256)])
def test_vectorized_matches_jax_on_distinct_slots(s, n):
    rng = np.random.default_rng(s)
    state, sharers, owner = random_directory(rng, s)
    slots = rng.permutation(s)[:n]
    req = rng.integers(0, 32, n)
    w = rng.integers(0, 2, n)
    args = (state, sharers, owner, slots, req, w)
    got = port_vectorized(*args)
    want = [np.asarray(o) for o in K.msi_transition_vectorized(
        *(jnp.asarray(a) for a in i32(*args)))]
    assert_equal(got, want)
    # On distinct slots packet order does not matter.
    assert_equal(got, port(*args))


def test_vectorized_out_of_range_inputs_follow_jax():
    """Negative slots count from the end, slots past the end are gathered
    clamped and dropped from the scatter, as jnp indexing does."""
    rng = np.random.default_rng(10)
    s = 20
    slots = np.concatenate([rng.permutation(np.arange(-s // 2, s // 2))[:12],
                            [s, s + 3, 5 * s]])
    n = len(slots)
    args = (rng.integers(-3, 6, s), rng.integers(-(1 << 31), 1 << 31, s),
            rng.integers(-3, 40, s), slots, rng.integers(-40, 40, n),
            rng.integers(0, 3, n))
    want = [np.asarray(o) for o in K.msi_transition_vectorized(
        *(jnp.asarray(a) for a in i32(*args)))]
    assert_equal(port_vectorized(*args), want)


def test_transition_table_equals_jax():
    got = P.build_transition_table()
    want = jax_transition_table()
    assert got.dtype == want.dtype == np.int32 and got.shape == (24, 5)
    np.testing.assert_array_equal(got, want)


def test_plain_is_the_wrappers_cpu_path():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in i32(*random_directory(rng, 16),
                                             rng.integers(0, 16, 50),
                                             rng.integers(0, 4, 50),
                                             rng.integers(0, 2, 50))]
    before = P.LAUNCHES["msi_transition"]
    for g, w in zip(P.msi_transition(*args), msi_transition_plain(*args)):
        assert torch.equal(g, w)
    assert P.LAUNCHES["msi_transition"] == before  # a CPU call is no launch


def test_wrapper_checks_its_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        P.msi_transition(z.long(), z, z, z, z, z)
    with pytest.raises(ValueError):  # is_write shorter than slots
        P.msi_transition(z, z, z, z, z, z[:3])
    with pytest.raises(ValueError):  # empty directory
        P.msi_transition(z[:0], z[:0], z[:0], z, z, z)
    with pytest.raises(ValueError):
        P.msi_transition_vectorized(z, z, z, z[None], z, z)


@pytest.mark.parametrize("b,nbytes", [(1, 1056), (4096, 132096),
                                      (4097, 132128 + 1024),
                                      (1_600_000, 51_200_000 + 391 * 1024)])
def test_cuda_workspace_covers_the_grouping(b, nbytes):
    """The CUDA kernel's scratch (csrc/directory_msi.cu checks it): sorted
    records int4 [B], keys and batch indices twice int32 [B], and the
    digit histograms int32 [256 x ceil(B / 4096)]."""
    assert P._msi_workspace_bytes(b) == nbytes
