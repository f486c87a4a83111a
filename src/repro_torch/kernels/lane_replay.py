"""Stage 3 of the switch pipeline: the MSI directory + blade-cache wave loop.

The JAX package runs this stage as one XLA program,
``repro/dataplane/engine.py::_replay = jax.jit(jax.vmap(_lane_replay))``.
On Hopper it is the hand-written CUDA kernel ``csrc/lane_replay.cu``
(launched by :func:`repro_torch.kernels.ops.lane_replay`); this module
holds its plain PyTorch version, :func:`lane_replay_plain`, a line-by-line
transcription of ``_lane_replay`` vectorized across lanes instead of
vmapped.  The CPU runs and the tests use it; on the card it is only the
yardstick the kernel is held to.

Three hazards, handled in both versions alike:

* **int32 bit semantics.**  Plane words use bit 31 (negative int32) and the
  packed output words are ``w1 = flags | kind << 4 | inval << 7`` and
  ``w2 = nfalse | dropped << 15``.  Here every bit-carrying value is held as
  its uint32 pattern in an int64 tensor, shifted with XLA's out-of-range
  rules (:func:`_shl`, :func:`_bit_at`) and wrapped back to int32 on store;
  popcounts are a SWAR count on those patterns (torch has no popcount).
* **Index clamping.**  ``lax.dynamic_slice`` / ``dynamic_update_slice``
  wrap a negative start once and clamp it into ``[0, dim - size]``; a gather
  wraps and clamps into ``[0, dim - 1]``; a scatter wraps and drops what is
  still out of range (:func:`_slice_start`, :func:`_gather_idx`,
  :func:`_scatter_idx`).  The engine's stream padding relies on in-range
  dummies: slot ``s_dev - 1``, ``w0`` padded to ``words`` and the planes
  widened by ``span`` columns.
* **Order inside a wave step.**  ``has`` is read before the multicast clear,
  the requester's bits after it, and ``ev`` / ``cev`` / ``down`` / ``v``
  mask the writes — transcribed, not restructured.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_I64 = torch.int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or small int64) values -> their uint32 bit patterns, as int64."""
    return x.to(_I64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held in int64 -> int32 (two's complement wrap)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _shl(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """XLA int32 shift_left on uint32 patterns: an amount outside [0, 32)
    gives 0."""
    ok = (k >= 0) & (k < 32)
    return torch.where(ok, (x << k.clamp(0, 31)) & _M32, torch.zeros_like(x))


def _bit_at(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``(x >> k) & 1`` with XLA's arithmetic shift: an amount outside
    [0, 32) yields the sign bit."""
    kk = torch.where((k >= 0) & (k < 32), k, torch.full_like(k, 31))
    return (x >> kk) & 1


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of uint32 patterns held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _gather_idx(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _slice_start(i: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    return torch.where(i < 0, i + dim, i).clamp(0, dim - size)


def _scatter_idx(i: torch.Tensor, n: int):
    j = torch.where(i < 0, i + n, i)
    return j.clamp(0, n - 1), (j >= 0) & (j < n)


def lane_replay_plain(nwaves, dkc, slot, blade, write, valid, ptype, w0, rw,
                      bit, dirrows, cmask, planes):
    """Plain PyTorch version of the stage-3 wave loop.

    Shapes: streams int32 ``[g, L]`` (``valid`` bool); ``dirrows`` int32
    ``[g, S, 4]`` = (state, sharers, owner, prepop); ``cmask`` int32
    ``[g, S, span]``; ``planes`` int32 ``[g, 2*NB, W]``, presence rows
    ``:NB`` and dirty rows ``NB:``.  Returns new ``(dirrows, planes, w1,
    w2, w3)``; the inputs are not modified.
    """
    dev = slot.device
    g, L = slot.shape
    S = dirrows.shape[1]
    span = cmask.shape[2]
    nb = planes.shape[1] // 2
    W = planes.shape[2]
    lanes = torch.arange(g, device=dev)
    blades_iota = torch.arange(nb, device=dev, dtype=_I64)
    cols = torch.arange(span, device=dev, dtype=_I64)
    rows = torch.arange(2 * nb, device=dev)
    dk = bool(dkc)

    # Bit-carrying state as uint32 patterns in int64 (see the module doc).
    dirs = dirrows.to(_I64).clone()
    pl = _u32(planes)
    cm = _u32(cmask)
    w1 = torch.zeros((g, L), dtype=_I64, device=dev)
    w2 = torch.zeros((g, L), dtype=_I64, device=dev)
    w3 = torch.zeros((g, L), dtype=_I64, device=dev)
    zero = torch.zeros(g, dtype=_I64, device=dev)
    one64 = torch.ones(g, dtype=_I64, device=dev)
    freed = torch.tensor([0, 0, -1, 0], dtype=_I64, device=dev)

    for i in range(min(int(nwaves), L)):
        s_raw = slot[:, i].to(_I64)
        b = blade[:, i].to(_I64)
        w = write[:, i].to(_I64)
        v = valid[:, i]
        ev = ptype[:, i] == 1
        cev = ptype[:, i] == 2
        w0i = w0[:, i].to(_I64)
        rwi = rw[:, i].to(_I64)
        biti = bit[:, i].to(_I64)
        me = _shl(one64, b)

        # ---- MAU stage 1: directory lookup ---------------------------
        s = _slice_start(s_raw, S, 1)
        drow = dirs[lanes, s]  # [g, 4]
        cst, cow, cpp = drow[:, 0], drow[:, 2], drow[:, 3]
        csh = drow[:, 1] & _M32
        mask = cm[lanes, s]  # [g, span]
        c0 = _slice_start(w0i, W, span)
        wcols = c0[:, None] + cols[None, :]  # [g, span]
        win = pl[lanes[:, None, None], rows[None, :, None], wcols[:, None, :]]
        win_p = win[:, :nb]
        win_d = win[:, nb:]
        bg = _gather_idx(b, nb)
        rg = _gather_idx(rwi, span)
        has = _bit_at(win_p[lanes, bg, rg], biti) == 1

        # ---- MAU stage 2: transition decode (CoherenceEngine oracle) -
        wr = w == 1
        others = csh & ~me & _M32
        is_i = cst == 0
        is_s = cst == 1
        is_m = cst == 2
        is_ow = cow == b
        in_sh = _bit_at(csh, b) == 1
        m_other = is_m & ~is_ow
        hit = torch.where(is_s, in_sh & has, is_m & is_ow & (has | (cpp == 1)))
        owner_bit = _shl(one64, cow.clamp(min=0))
        inval = torch.where(is_s & wr, others,
                            torch.where(m_other, owner_bit, zero))
        fetch = ~hit
        seq = m_other
        par = is_s & wr & (others != 0)
        new_st = torch.where(wr | (is_m & is_ow), 2, 1).to(_I64)
        down = dk & m_other & ~wr & ~ev & ~cev
        down_sh = me | owner_bit
        new_sh = torch.where(is_m & is_ow, csh,
                             torch.where(is_s & ~wr, csh | me,
                                         torch.where(down, down_sh, me)))
        new_ow = torch.where(is_m & is_ow, cow,
                             torch.where(wr, b, torch.full_like(b, -1)))
        new_pp = torch.where(m_other | (is_s & wr), zero, cpp)
        kind = torch.where(
            is_i, torch.where(wr, 1, 0),
            torch.where(is_s, torch.where(wr, 3, 2),
                        torch.where(m_other & ~wr, 5, 4))).to(_I64)

        # ---- capacity-eviction packets: multicast to sharers/owner ---
        ev_targets = torch.where(is_s, csh,
                                 torch.where(cow >= 0, owner_bit, zero))
        inval = torch.where(ev, ev_targets, torch.where(cev, zero, inval))

        # ---- egress multicast: invalidation + false-inval accounting -
        sel = _bit_at(inval[:, None], blades_iota[None, :]) == 1  # [g, NB]
        pcnt = _popcount(win_p & mask[:, None, :]).sum(-1)
        dcnt = _popcount(win_d & mask[:, None, :]).sum(-1)
        reqb = torch.where(ev[:, None], 0,
                           _bit_at(win_p[lanes, :, rg], biti[:, None]))
        dropped = torch.where(down, zero, torch.where(sel, pcnt, 0).sum(-1))
        flushed = torch.where(sel, dcnt, 0).sum(-1)
        nfalse = torch.where(down, zero,
                             torch.where(sel, pcnt - reqb, 0).sum(-1))
        nmask = (~mask & _M32)[:, None, :]
        win_p = torch.where((sel & ~down[:, None])[:, :, None],
                            win_p & nmask, win_p)
        win_d = torch.where(sel[:, :, None], win_d & nmask, win_d)

        # ---- requester-side data movement (accesses only), or the
        # victim-bit clear of a blade-cache eviction packet -------------
        cur_p = win_p[lanes, bg, rg]
        cur_d = win_d[lanes, bg, rg]
        old_dirty = _bit_at(cur_d, biti)
        new_dirty = torch.where(has, old_dirty, zero) | w
        one = _shl(one64, biti)
        ins_p = torch.where(cev, cur_p & ~one & _M32, cur_p | one)
        ins_d = torch.where(cev, cur_d & ~one & _M32,
                            (cur_d & ~one & _M32) | _shl(new_dirty & _M32, biti))
        # A dropped scatter rewrites the word already at the clamped index
        # (no boolean indexing: it would synchronize with the device).
        bs, bok = _scatter_idx(b, nb)
        rs, rok = _scatter_idx(rwi, span)
        put = bok & rok
        win_p[lanes, bs, rs] = torch.where(put, torch.where(ev, cur_p, ins_p),
                                           win_p[lanes, bs, rs])
        win_d[lanes, bs, rs] = torch.where(put, torch.where(ev, cur_d, ins_d),
                                           win_d[lanes, bs, rs])

        # ---- write-back (fused recirculation) ------------------------
        newwin = torch.where(v[:, None, None], torch.cat([win_p, win_d], 1),
                             win)
        pl[lanes[:, None, None], rows[None, :, None], wcols[:, None, :]] = newwin
        newrow = torch.where(ev[:, None], freed[None, :],
                             torch.stack([new_st, new_sh, new_ow, new_pp], 1))
        newrow = torch.where(cev[:, None], drow, newrow)
        newrow = torch.where(v[:, None], newrow, drow)
        dirs[lanes, s] = newrow
        word1 = (hit.to(_I64) | (fetch.to(_I64) << 1) | (seq.to(_I64) << 2)
                 | (par.to(_I64) << 3) | _shl(kind, torch.full_like(kind, 4))
                 | _shl(inval, torch.full_like(inval, 7)))
        word2 = (nfalse & _M32) | _shl(dropped & _M32,
                                       torch.full_like(dropped, 15))
        w1[:, i] = torch.where(v, word1, zero)
        w2[:, i] = torch.where(v, word2, zero)
        w3[:, i] = torch.where(v, flushed & _M32, zero)

    # sharers are stored as int32 bit patterns; the other row fields are
    # small signed values.
    dirs[:, :, 1] = dirs[:, :, 1] & _M32
    return (_i32(dirs & _M32), _i32(pl), _i32(w1), _i32(w2), _i32(w3))
