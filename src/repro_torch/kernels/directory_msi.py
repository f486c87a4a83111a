"""In-network MSI directory transitions (MIND §6.3).

The switch keeps the directory entries in one MAU stage and a
*materialized state-transition table* in the next; a packet looks up its
entry, reads its actions from the table and recirculates to write the
entry back.  Requests are applied in batch order, which is the switch's
packet serialisation: two requests to one slot see each other's effect.

The JAX package runs this as the Pallas TPU kernel
``repro/kernels/directory_msi.py::_msi_kernel``; on Hopper it is the
hand-written CUDA kernel ``csrc/directory_msi.cu`` (launched by
:func:`repro_torch.kernels.ops.msi_transition`).  This module holds the
port's copy of the action codes and of :func:`build_transition_table`, the
kernel's plain version :func:`msi_transition_plain` (the packet-order loop,
on the host), :func:`msi_transition_grouped_plain` (the kernel's algorithm:
requests grouped by slot, each slot's chain walked in order), and
:func:`msi_transition_vectorized`, the reference's conflict-free variant,
which is plain tensor code there too.

Directory layout:
    state:   int32 [S]  (0=I, 1=S, 2=M)
    sharers: int32 [S]  (bitmap over <= 32 compute blades)
    owner:   int32 [S]  (-1 if none)
Outputs per request:
    fetch_src:  -1 local hit, -2 home memory blade, >= 0 fetch-from-owner
    inval_mask: sharer bitmap the egress multicast must invalidate

Semantics kept from the reference, as XLA computes them, for any int32
input: ``1 << k`` is 0 for ``k`` outside [0, 31] and ``1 << 31`` wraps to
INT32_MIN; ``x >> k`` fills with the sign bit for ``k`` outside [0, 31];
the table row and the slot are indices as jnp reads them (a negative one
counts from the end once, then it is clamped into range); the row index
wraps in int32.
"""

from __future__ import annotations

import numpy as np
import torch

# Action codes in the materialized table.
FETCH_LOCAL, FETCH_MEM, FETCH_OWNER = 0, 1, 2
INV_NONE, INV_OTHERS, INV_OWNER = 0, 1, 2
SH_KEEP, SH_SET_ME, SH_OR_ME = 0, 1, 2
OW_KEEP, OW_SET_REQ, OW_CLEAR = 0, 1, 2

I, S, M = 0, 1, 2

TABLE_ROWS = 24


def build_transition_table() -> np.ndarray:
    """Materialize all (state, is_write, is_owner, in_sharers) transitions.

    Rows indexed by ((state*2 + is_write)*2 + is_owner)*2 + in_sharers;
    columns = (new_state, fetch_kind, inval_kind, sharers_code, owner_code).
    """
    tbl = np.zeros((TABLE_ROWS, 5), np.int32)

    def put(st, w, is_ow, in_sh, row):
        tbl[((st * 2 + w) * 2 + is_ow) * 2 + in_sh] = row

    for is_ow in (0, 1):
        for in_sh in (0, 1):
            # I + read -> S, fetch memory.
            put(I, 0, is_ow, in_sh, (S, FETCH_MEM, INV_NONE, SH_SET_ME, OW_CLEAR))
            # I + write -> M, fetch memory.
            put(I, 1, is_ow, in_sh, (M, FETCH_MEM, INV_NONE, SH_SET_ME, OW_SET_REQ))
    # S + read: local if already sharer else memory fetch; join sharers.
    for is_ow in (0, 1):
        put(S, 0, is_ow, 1, (S, FETCH_LOCAL, INV_NONE, SH_OR_ME, OW_CLEAR))
        put(S, 0, is_ow, 0, (S, FETCH_MEM, INV_NONE, SH_OR_ME, OW_CLEAR))
        # S + write: invalidate the other sharers.
        put(S, 1, is_ow, 1, (M, FETCH_LOCAL, INV_OTHERS, SH_SET_ME, OW_SET_REQ))
        put(S, 1, is_ow, 0, (M, FETCH_MEM, INV_OTHERS, SH_SET_ME, OW_SET_REQ))
    for in_sh in (0, 1):
        # M + read @ owner: local.   M + read elsewhere: owner flush.
        put(M, 0, 1, in_sh, (M, FETCH_LOCAL, INV_NONE, SH_KEEP, OW_KEEP))
        put(M, 0, 0, in_sh, (S, FETCH_OWNER, INV_OWNER, SH_SET_ME, OW_CLEAR))
        # M + write @ owner: local.  M + write elsewhere: owner flush.
        put(M, 1, 1, in_sh, (M, FETCH_LOCAL, INV_NONE, SH_KEEP, OW_KEEP))
        put(M, 1, 0, in_sh, (M, FETCH_OWNER, INV_OWNER, SH_SET_ME, OW_SET_REQ))
    return tbl


# --------------------------------------------------------------------- #
# XLA's int32 rules, on Python ints (the sequential loop) ...
# --------------------------------------------------------------------- #
def _wrap(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _shl1(k: int) -> int:
    return _wrap(1 << k) if 0 <= k < 32 else 0


def _sar(x: int, k: int) -> int:
    return x >> (k if 0 <= k < 32 else 31)


def _index(i: int, n: int) -> int:
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def _transition(tbl, st, sh, ow, req, w):
    """One request on one directory entry: the new ``(state, sharers,
    owner)`` and the request's ``(fetch_src, inval_mask)``."""
    me = _shl1(req)
    # MAU stage 2: the materialized transition table.
    is_ow = int(ow == req)
    in_sh = _sar(sh, req) & 1
    idx = _index(_wrap(((st * 2 + w) * 2 + is_ow) * 2 + in_sh), TABLE_ROWS)
    new_state, fetch_kind, inval_kind, sh_code, ow_code = tbl[idx]
    fetch = (-1 if fetch_kind == FETCH_LOCAL
             else -2 if fetch_kind == FETCH_MEM else ow)
    inval = (sh & ~me if inval_kind == INV_OTHERS
             else _shl1(ow) if inval_kind == INV_OWNER else 0)
    # Write-back (the recirculation).
    new_sh = (me if sh_code == SH_SET_ME
              else sh | me if sh_code == SH_OR_ME else sh)
    new_ow = (req if ow_code == OW_SET_REQ
              else -1 if ow_code == OW_CLEAR else ow)
    return new_state, new_sh, new_ow, fetch, inval


def msi_transition_plain(state, sharers, owner, slots, requesters, is_write):
    """Sequential (packet-order) MSI over one request batch: the loop of
    the reference's ``_msi_kernel``, one request at a time, on the host.

    All arguments are int32 tensors on one device: ``state``, ``sharers``,
    ``owner`` ``[S]`` (S > 0); ``slots``, ``requesters``, ``is_write``
    ``[B]``.  Returns new ``(state, sharers, owner, fetch_src,
    inval_mask)`` on that device; the inputs are left as they are."""
    dev = state.device
    st_a, sh_a, ow_a = state.tolist(), sharers.tolist(), owner.tolist()
    tbl = build_transition_table().tolist()
    n = len(st_a)
    fetch, inval = [], []
    for slot, req, w in zip(slots.tolist(), requesters.tolist(),
                            is_write.tolist()):
        slot = _index(slot, n)
        # MAU stage 1: directory lookup.
        st_a[slot], sh_a[slot], ow_a[slot], f, v = _transition(
            tbl, st_a[slot], sh_a[slot], ow_a[slot], req, w)
        fetch.append(f)
        inval.append(v)
    return tuple(_out(a, dev) for a in (st_a, sh_a, ow_a, fetch, inval))


def msi_transition_grouped_plain(state, sharers, owner, slots, requesters,
                                 is_write):
    """Plain model of the CUDA kernel's algorithm (on no path; the CPU tests
    hold it to the reference): a request reads and writes only its own
    slot's entry, so the batch is grouped by the clamped slot with a stable
    sort, and each slot's chain is walked in batch order with the entry
    held aside, written back once at the end of the chain.  Arguments and
    results as :func:`msi_transition_plain`."""
    dev = state.device
    st_a, sh_a, ow_a = state.tolist(), sharers.tolist(), owner.tolist()
    tbl = build_transition_table().tolist()
    keys = _index_t(slots, len(st_a))
    order = torch.sort(keys, stable=True).indices
    keys, order = keys[order].tolist(), order.tolist()
    req, w = requesters.tolist(), is_write.tolist()
    b = len(order)
    fetch, inval = [0] * b, [0] * b
    j = 0
    while j < b:
        slot = keys[j]
        entry = st_a[slot], sh_a[slot], ow_a[slot]
        while j < b and keys[j] == slot:
            i = order[j]
            *entry, fetch[i], inval[i] = _transition(tbl, *entry, req[i],
                                                     w[i])
            j += 1
        st_a[slot], sh_a[slot], ow_a[slot] = entry
    return tuple(_out(a, dev) for a in (st_a, sh_a, ow_a, fetch, inval))


def _out(a, dev):
    return torch.tensor(a, dtype=torch.int32, device=dev)


# --------------------------------------------------------------------- #
# ... and on tensors (the vectorized variant).
# --------------------------------------------------------------------- #
def _shl1_t(k: torch.Tensor) -> torch.Tensor:
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, torch.ones_like(k) << k.clamp(0, 31), 0)


def _sar_t(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return x >> torch.where((k >= 0) & (k < 32), k, 31)


def _index_t(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(i < 0, i + n, i).clamp(0, n - 1).long()


def msi_transition_vectorized(state, sharers, owner, slots, requesters,
                              is_write):
    """Conflict-free batches (all ``slots`` distinct) processed at once, no
    packet serialisation: the reference's ``msi_transition_vectorized``
    line for line, as tensor gathers and scatters.  Its contract holds
    only for distinct slots.  Arguments and results as
    :func:`msi_transition_plain`."""
    n = state.shape[0]
    ttable = torch.from_numpy(build_transition_table()).to(state.device)
    req = requesters
    w = is_write
    me = _shl1_t(req)
    gather = _index_t(slots, n)
    st = state[gather]
    sh = sharers[gather]
    ow = owner[gather]
    is_ow = (ow == req).to(torch.int32)
    in_sh = _sar_t(sh, req) & 1
    idx = ((st * 2 + w) * 2 + is_ow) * 2 + in_sh
    row = ttable[_index_t(idx, TABLE_ROWS)]
    fetch = torch.where(row[:, 1] == FETCH_LOCAL, -1,
                        torch.where(row[:, 1] == FETCH_MEM, -2, ow))
    inval = torch.where(row[:, 2] == INV_OTHERS, sh & ~me,
                        torch.where(row[:, 2] == INV_OWNER, _shl1_t(ow), 0))
    new_sh = torch.where(row[:, 3] == SH_SET_ME, me,
                         torch.where(row[:, 3] == SH_OR_ME, sh | me, sh))
    new_ow = torch.where(row[:, 4] == OW_SET_REQ, req,
                         torch.where(row[:, 4] == OW_CLEAR, -1, ow))
    # Scatters drop an index outside [0, S) after the negative wrap, as
    # ``.at[].set`` does.
    scatter = torch.where(slots < 0, slots + n, slots).long()
    keep = (scatter >= 0) & (scatter < n)
    scatter = scatter[keep]
    new_state = state.clone()
    new_sharers = sharers.clone()
    new_owner = owner.clone()
    new_state[scatter] = row[:, 0][keep]
    new_sharers[scatter] = new_sh[keep]
    new_owner[scatter] = new_ow[keep]
    return (new_state, new_sharers, new_owner, fetch.to(torch.int32),
            inval.to(torch.int32))
