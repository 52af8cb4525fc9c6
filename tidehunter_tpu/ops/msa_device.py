"""Device-resident profile-POA consensus on the GPU.

All MSA state stays on the device across unit rounds:

  counts [B, T, 5] int16   profile column base counts
  n_placed, ncol, overflow per region

and each unit round is one jitted dispatch of three parts:

  1. scores_step (XLA): substitution scores + weighted-deletion prefix
     sums from counts — the same fixed-point arithmetic as
     ops/poa_profile.Profile.sub_scores/del_weights — laid out as one
     column table per region, plus the round's unit as a reversed query.
  2. The DP + backtrack kernel (Pallas through Triton), one program per
     region.  The profile Gotoh DP runs in ANTI-DIAGONAL form: the
     row-major form needs a prefix-cummax per row for the
     occupancy-weighted deletion track, while on the wavefront the same
     track is the ordinary elementwise recurrence F[j][c] =
     max(G[j][c-1] - od, F[j][c-1]) - wdel[c] because (j, c-1) lives on
     the previous anti-diagonal.  The program loops over its own
     qlen + ncol - 1 anti-diagonals, streams one direction byte per cell
     (sel | icont<<2 | fcont<<3 | track bits) to device memory, then walks
     its path back in the same program: every backtrack step decreases
     j + c by one (M by two), and the m-th emitted op lands at lane
     NL-1-m, so the ops read left to right are the forward alignment.
  3. update_step (XLA): Profile.update_arrays as batched gathers.

Tie-break rules (M over I over D; I-run continuation on strict >; D-run
continuation on >=) are exactly those of ops/poa_profile.align_to_profile,
so consensus output is bit-identical with the host profile_consensus and
its banded mirror banded_profile_consensus.  Everything is integer
arithmetic: results are exact, on any device.

The consensus (majority base per column, column dropped when gaps
outnumber the best base, coverage = count of units with the consensus
base — the abPOA RC contract, reference src/abpoa_cons.c:92-107) is
extracted on device and pulled ONCE per region batch.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .poa_profile import SCALE, band_ladder
from .wavefront import (barrier, lanes, num_warps, reversed_query,
                        shift_right, where)

NEG = -(1 << 30)
OP_M, OP_I, OP_D = 0, 1, 2
# carried DP planes: H at r-2 and r-1, the two insertion tracks, the two
# deletion tracks, and G = max(M, E)
_HP2, _HP, _E, _E2, _F, _F2, _G = range(7)
_SHIFTED = (_HP2, _G, _F, _F2)      # planes read at their left neighbour
# rows of the per-region column table (scores_step)
_N_COL = 9                          # sub[0..4], wl, wdel, wl2, wdel2


def band_base(r, T: int, W: int):
    """Per-row window base for the |c-j| <= wb band (wb = W - 8): the
    band's live lane range at anti-diagonal r is [(r-wb)/2, (r+wb)/2]
    (wb+1 lanes), so the base slides by exactly one lane every two rows;
    clamped to [0, T-W].  The -2 keeps two lanes of left slack so a
    left-band-edge cell's in-band M/F predecessors are still inside the
    window after the slide.  Works with python-int and traced r."""
    wb = W - 8
    if isinstance(r, int):
        return max(0, min(((r - wb) >> 1) - 2, T - W))
    base = jax.lax.shift_right_arithmetic(r - wb, jnp.int32(1)) - 2
    return jnp.maximum(0, jnp.minimum(base, T - W))


def _msa_row(r, ti, qb, col, wl_sh, wl2_sh, cur, sh, Lq, Tn, costs, wb):
    """One anti-diagonal of the dual-affine profile DP, elementwise.

    Interior cell (j, c) sits at lane ti = c - 1 with j = r - ti + 1.
    col: the column table at ti; wl_sh/wl2_sh: the prefix deletion
    weights at ti - 1 (0 at ti == 0); cur: the 7 carried planes; sh: the
    _SHIFTED planes at ti - 1.  wb: half band (None = full width).
    Returns the next carried planes and the masked direction byte."""
    oi, ei, od, oi2, ei2, od2 = costs
    s0, s1, s2, s3, s4, Wl, wd, Wl2, wd2 = col
    hp2, hp, e, e2, f, f2, g = cur
    hp2_s, g_s, f_s, f2_s = sh
    mask = ((ti <= r) & (ti >= r - Lq + 1) & (ti < Tn)
            & (r < Lq + Tn - 1))
    if wb is not None:
        # predecessor band masks: out-of-band neighbours read as NEG so
        # the band semantics equal the host mirror's row masking exactly
        off = 2 * ti - r                  # c - j of the current cell
        mask = mask & (jnp.abs(off) <= wb)
        m_up = jnp.abs(off + 1) <= wb     # (j-1, c)
        m_dl = jnp.abs(off - 1) <= wb     # (j, c-1)

    s = where(qb == 1, s1, s0)
    s = where(qb == 2, s2, s)
    s = where(qb == 3, s3, s)
    s = where(qb == 4, s4, s)

    # convex (dual-affine) boundaries: best pure-insertion of g bases =
    # -min(oi+g*ei, oi2+g*ei2); best pure-deletion of a column prefix =
    # -min(od+W1, od2+W2)  (abPOA contract, reference src/abpoa_cons.c:15-20)
    def ins0(n):
        return jnp.maximum(-(oi + n * ei), -(oi2 + n * ei2))

    # M: H[j-1][c-1] at (r-2, ti-1)
    hm = where(ti == 0, ins0(r), hp2_s)
    hm = where(
        ti == r,
        where(ti == 0, 0, jnp.maximum(-(od + wl_sh), -(od2 + wl2_sh))),
        hm)
    M = hm + s

    # E (insertion, consumes unit): refs at (r-1, ti); two tracks
    h_up = where(ti == r, jnp.maximum(-(od + Wl), -(od2 + Wl2)), hp)
    top = ti == r
    if wb is not None:
        h_up = where(m_up, h_up, NEG)
        top = top | ~m_up
    e_up = where(top, NEG, e)
    e_open = h_up - oi - ei
    e_cont = e_up - ei
    E1 = jnp.maximum(e_open, e_cont)
    icont1 = e_cont > e_open
    e2_up = where(top, NEG, e2)
    e2_open = h_up - oi2 - ei2
    e2_cont = e2_up - ei2
    E2 = jnp.maximum(e2_open, e2_cont)
    icont2 = e2_cont > e2_open
    E = jnp.maximum(E1, E2)
    isel2 = E2 > E1

    # F (deletion, consumes column): refs at (r-1, ti-1); two tracks
    g_sh = where(ti == 0, ins0(r + 1), g_s)
    left = ti == 0
    if wb is not None:
        g_sh = where(m_dl, g_sh, NEG)
        left = left | ~m_dl
    f_sh = where(left, NEG, f_s)
    F1 = jnp.maximum(g_sh - od, f_sh) - wd
    fcont1 = f_sh >= (g_sh - od)
    f2_sh = where(left, NEG, f2_s)
    F2 = jnp.maximum(g_sh - od2, f2_sh) - wd2
    fcont2 = f2_sh >= (g_sh - od2)
    F = jnp.maximum(F1, F2)
    fsel2 = F2 > F1

    G = jnp.maximum(M, E)
    H = jnp.maximum(G, F)
    sel = where(F > G, 2, where(E > M, 1, 0))
    d = (sel
         | where(icont1, 4, 0) | where(fcont1, 8, 0)
         | where(isel2, 16, 0) | where(fsel2, 32, 0)
         | where(icont2, 64, 0) | where(fcont2, 128, 0))
    nxt = (hp, where(mask, H, hp2),
           where(mask, E1, e), where(mask, E2, e2),
           where(mask, F1, f), where(mask, F2, f2),
           where(mask, G, g))
    return nxt, where(mask, d, 0)


def _bt_step(val, j, c, mode):
    """One backtrack step from cell (j, c) with direction byte val.
    mode: -1 fresh; 1 = I run track 1; 2 = D run track 1; 3 = I run
    track 2; 4 = D run track 2 (runs commit to a track at entry — the
    convex model's per-run min).  Returns (op, j, c, mode) after it."""
    d = val & 3
    icont1 = (val >> 2) & 1
    fcont1 = (val >> 3) & 1
    isel2 = (val >> 4) & 1
    fsel2 = (val >> 5) & 1
    icont2 = (val >> 6) & 1
    fcont2 = (val >> 7) & 1
    in_run = mode > 0
    run_is_i = in_run & ((mode == 1) | (mode == 3))
    run_is_d = in_run & ((mode == 2) | (mode == 4))
    sel = where(run_is_i, 1, where(run_is_d, 2, d))
    sel = where(j == 0, 2, where(c == 0, 1, sel))
    is_m = sel == 0
    is_i = sel == 1
    op = where(is_m, OP_M, where(is_i, OP_I, OP_D))
    # a run keeps its entry track; a fresh I/D step picks by this cell's
    # isel2/fsel2
    i_trk2 = where(in_run, (mode == 3).astype(jnp.int32), isel2)
    d_trk2 = where(in_run, (mode == 4).astype(jnp.int32), fsel2)
    icont = where(i_trk2 == 1, icont2, icont1)
    fcont = where(d_trk2 == 1, fcont2, fcont1)
    nmode = where(
        is_m, -1,
        where(
            is_i,
            where(icont == 1, where(i_trk2 == 1, 3, 1), -1),
            where(fcont == 1, where(d_trk2 == 1, 4, 2), -1)))
    j2 = j - (is_m | is_i).astype(jnp.int32)
    c2 = c - (sel != 1).astype(jnp.int32)
    return op, j2, c2, nmode


# ------------------------------------------------------ DP + backtrack --


def _dp_bt_kernel(zq_ref, col_ref, meta_ref, dirs_ref, ops_ref, nst_ref,
                  scr_ref, *, T, W, WL, NL, costs, interpret):
    """One region per program: the DP over its own anti-diagonals, then
    its backtrack.  Outputs: dirs [B, 2T-1, WL] uint8 (working memory),
    ops [B, NL] int8 (m-th emitted op at lane NL-1-m), nst [B, 2] int32
    (steps emitted = new profile width, band-touch flag: the path came
    within 8 of the |c-j| band edge)."""
    b = pl.program_id(0)
    Lq = meta_ref[b, 0]
    Tn = meta_ref[b, 1]
    li = jax.lax.broadcasted_iota(jnp.int32, (WL,), 0)
    wb = None if W is None else W - 8
    ZS = T + WL - 1
    if W is not None:
        # slack lane past the window: the fill a left slide exposes
        for par in range(2):
            for k in range(7):
                scr_ref[b, par, k, WL + 1] = jnp.int32(NEG)

    def row(r, cur):
        if W is None:
            base = 0
            cur_v = cur
            sh = shift_right(scr_ref, b, r, [cur[k] for k in _SHIFTED], WL,
                             interpret)
        else:
            # the window slides right one lane every two rows: read the
            # carried planes back at +shift (slid) and +shift-1 (left
            # neighbours)
            base = band_base(r, T, W)
            shift = base - band_base(r - 1, T, W)
            par = jax.lax.bitwise_and(r, jnp.int32(1))
            for k in range(7):
                scr_ref[b, par, k, pl.ds(1, WL)] = cur[k]
            barrier(interpret)
            cur_v = [scr_ref[b, par, k, pl.ds(1 + shift, WL)]
                     for k in range(7)]
            sh = [scr_ref[b, par, k, pl.ds(shift, WL)] for k in _SHIFTED]
        qb = zq_ref[b, pl.ds(ZS - r + base, WL)]
        col = [col_ref[b, k, pl.ds(base + 1, WL)] for k in range(_N_COL)]
        wl_sh = col_ref[b, 5, pl.ds(base, WL)]
        wl2_sh = col_ref[b, 7, pl.ds(base, WL)]
        nxt, d = _msa_row(r, li + base, qb, col, wl_sh, wl2_sh, cur_v, sh,
                          Lq, Tn, costs, wb)
        dirs_ref[b, r, pl.ds(0, WL)] = d.astype(jnp.uint8)
        return nxt

    init = tuple(jnp.full((WL,), NEG, jnp.int32) for _ in range(7))
    jax.lax.fori_loop(0, Lq + Tn - 1, row, init)
    barrier(interpret)

    def bt_body(st):
        j, c, mode, m, tch = st
        # cell (j, c) sits on row j+c-2, lane c-1 of the window at that
        # row; only interior cells inside the window are stored
        drow = jnp.maximum(j + c - 2, 0)
        lane = c - 1 - (0 if W is None else band_base(drow, T, W))
        ok = (j > 0) & (c > 0) & (lane >= 0) & (lane < WL)
        lane = jnp.clip(lane, 0, WL - 1)
        val = where(ok, dirs_ref[b, drow, lane].astype(jnp.int32), 0)
        if wb is not None:
            tch = where(jnp.abs(c - j) >= wb - 8, 1, tch)
        op, j, c, mode = _bt_step(val, j, c, mode)
        ops_ref[b, NL - 1 - m] = op.astype(jnp.int8)
        return j, c, mode, m + 1, tch

    _, _, _, m, tch = jax.lax.while_loop(
        lambda st: (st[0] > 0) | (st[1] > 0), bt_body,
        (Lq, Tn, jnp.int32(-1), jnp.int32(0), jnp.int32(0)))
    nst_ref[b, 0] = m
    nst_ref[b, 1] = tch


def _dp_bt_call(zq, col, meta, *, T, W, WL, NL, costs, interpret):
    B = zq.shape[0]
    n_scr = len(_SHIFTED) if W is None else 7
    kern = functools.partial(_dp_bt_kernel, T=T, W=W, WL=WL, NL=NL,
                             costs=costs, interpret=interpret)
    _, ops, nst, _ = pl.pallas_call(
        kern,
        grid=(B,),
        out_shape=(
            jax.ShapeDtypeStruct((B, 2 * T - 1, WL), jnp.uint8),
            jax.ShapeDtypeStruct((B, NL), jnp.int8),
            jax.ShapeDtypeStruct((B, 2), jnp.int32),
            jax.ShapeDtypeStruct((B, 2, n_scr, WL + 2), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=num_warps(WL), num_stages=1),
        interpret=interpret,
    )(zq, col, meta)
    return ops, nst


# ------------------------------------------------------------ jit steps --


def _relayout_shift(counts, consumes_c, kmap, kmax):
    """old[p] = counts[col(p)-1] as a shift-accumulate loop: the shift
    p - (col(p)-1) equals the I-step prefix count, nondecreasing and
    bounded by the round's insertions, so K cheap elementwise passes
    replace a gather."""
    def body(state):
        k, acc, shifted = state
        sel = consumes_c & (kmap == k)
        acc = where(sel[:, :, None], shifted, acc)
        return k + 1, acc, jnp.roll(shifted, 1, axis=1)

    _, acc, _ = jax.lax.while_loop(
        lambda s: s[0] <= kmax, body,
        (jnp.int32(0), jnp.zeros_like(counts), counts))
    return acc


def _relayout_gather(counts, consumes_c, colz):
    g = jnp.take_along_axis(counts, colz[:, :, None], axis=1)
    return where(consumes_c[:, :, None], g, jnp.int16(0))


def _build_jits(match: int, mismatch: int, gap_open: int, gap_ext: int,
                gap_open2: int, gap_ext2: int):
    costs = (SCALE * gap_open, SCALE * gap_ext, SCALE * gap_open,
             SCALE * gap_open2, SCALE * gap_ext2, SCALE * gap_open2)

    @jax.jit
    def gather_step(units_dev, ulen_dev, nunits, k):
        """Round-k unit gather, kept out of the fused round so the
        U-dimension (units_dev.shape[1], which varies per region batch)
        never appears in the kernel-bearing executable's shapes."""
        active = k < nunits
        unit_k = jnp.take(units_dev, k, axis=1).astype(jnp.int32)
        qlen_k = where(active, jnp.take(ulen_dev, k, axis=1), 1
                           ).astype(jnp.int32)
        return unit_k, qlen_k, active

    @functools.partial(jax.jit, static_argnames=("WL",))
    def scores_step(counts, n_placed, ncol, unit_k, WL):
        """Column table [B, 9, max(T, WL) + 1] (substitution scores for
        the 5 bases, deletion weights and their prefix sums for both gap
        tracks, one leading zero column so lane t-1 is one load) and the
        round's unit as a reversed query.  counts arrive int16 (base
        counts <= units per region) and widen here."""
        counts = counts.astype(jnp.int32)
        B, T, _ = counts.shape
        ci = jnp.arange(T)[None, :]
        occ = counts.sum(axis=2)
        occ1 = jnp.maximum(occ, 1)
        raw = SCALE * ((match + mismatch) * counts
                       - mismatch * occ1[:, :, None])
        sub = jnp.floor_divide(raw, occ1[:, :, None])      # [B, T, 5]
        sub = where((ci < ncol[:, None])[:, :, None], sub, -SCALE * 64)
        planes = [sub[:, :, k] for k in range(5)]
        for ge in (gap_ext, gap_ext2):
            wdel = jnp.floor_divide(SCALE * ge * occ,
                                    jnp.maximum(n_placed, 1)[:, None])
            wdel = where(ci < ncol[:, None], wdel, 0)
            planes += [jnp.cumsum(wdel, axis=1), wdel]
        col = jnp.stack(planes, axis=1).astype(jnp.int32)
        col = jnp.pad(col, ((0, 0), (0, 0), (1, max(T, WL) - T)))
        return reversed_query(unit_k, WL), col

    @jax.jit
    def update_step(counts, n_placed, ncol, overflow, unit, qlen, active,
                    ops_c, nst):
        """Profile update from the compacted right-anchored ops: forward
        step p is at lane p + NP - nsteps, and because new column index ==
        step index, the whole update is gathers + masks — no scatters."""
        B, T, _ = counts.shape
        NP = ops_c.shape[1]
        unit = unit.astype(jnp.int32)
        posT = jnp.arange(T)[None, :]
        src = posT + (NP - nst)                                  # nst [B,1]
        op = jnp.take_along_axis(
            ops_c, jnp.clip(src, 0, NP - 1), axis=1).astype(jnp.int32)
        valid = (posT < nst) & active[:, None]
        is_i = op == OP_I
        is_d = op == OP_D
        consumes_c = valid & ~is_i
        consumes_q = valid & ~is_d
        col = jnp.cumsum(consumes_c.astype(jnp.int32), axis=1)   # 1-based
        qp = jnp.cumsum(consumes_q.astype(jnp.int32), axis=1) - 1

        base = jnp.take_along_axis(
            unit, jnp.clip(qp, 0, unit.shape[1] - 1), axis=1)
        base = where(consumes_q, base, 5)
        onehot = jax.nn.one_hot(base, 5, dtype=jnp.int16)        # [B, T, 5]

        colz = jnp.clip(col - 1, 0, T - 1)
        kmap = where(consumes_c, posT - colz, 0)
        kmax = jnp.max(kmap)
        # pathological insertion counts fall back to the gather
        old = jax.lax.cond(
            kmax <= 64,
            lambda: _relayout_shift(counts, consumes_c, kmap, kmax),
            lambda: _relayout_gather(counts, consumes_c, colz))
        new = old + where(valid[:, :, None], onehot, jnp.int16(0))

        nsteps = nst[:, 0]
        counts2 = where(active[:, None, None], new, counts)
        ncol2 = where(active, jnp.minimum(nsteps, T), ncol)
        overflow2 = overflow | (active & (nsteps > T))
        n_placed2 = n_placed + active.astype(jnp.int32)
        return counts2, n_placed2, ncol2, overflow2

    @jax.jit
    def polish_update(votes, ncol, active, unit, ops_c, nst):
        """Frozen-layout vote accumulation: only M steps into existing
        columns count (the host polish rule, ops/poa_profile.py
        profile_consensus polish loop).  Realigns the compacted ops to
        forward order over the FULL width (steps past position T can
        still vote into columns < T when insertions pushed them there)."""
        B, T, _ = votes.shape
        NP = ops_c.shape[1]
        pos = jnp.arange(NP)[None, :]
        srcl = pos + (NP - nst)
        op = jnp.take_along_axis(
            ops_c, jnp.clip(srcl, 0, NP - 1), axis=1).astype(jnp.int32)
        unit = unit.astype(jnp.int32)
        valid = (pos < nst) & active[:, None]
        consumes_c = valid & (op != OP_I)
        consumes_q = valid & (op != OP_D)
        col = jnp.cumsum(consumes_c.astype(jnp.int32), axis=1) - 1
        qp = jnp.cumsum(consumes_q.astype(jnp.int32), axis=1) - 1
        is_m = valid & (op == OP_M)
        base = jnp.take_along_axis(
            unit, jnp.clip(qp, 0, unit.shape[1] - 1), axis=1)
        onehot = jax.nn.one_hot(
            where(is_m, base, 5), 5, dtype=jnp.int16)
        dest = where(is_m & (col < T), col, T)
        bidx = jnp.broadcast_to(jnp.arange(B)[:, None], dest.shape)
        padded = jnp.zeros((B, T + 1, 5), jnp.int16)
        padded = padded.at[bidx, dest].add(onehot)
        return votes + padded[:, :T, :]

    @jax.jit
    def init_step(units_dev, ulen_dev):
        """Initial profile = one-hot of unit 0."""
        B, _, T = units_dev.shape
        ci = jnp.arange(T)[None, :]
        first = units_dev[:, 0, :].astype(jnp.int32)
        fl = ulen_dev[:, 0]
        oh = jax.nn.one_hot(first, 5, dtype=jnp.int16)
        counts = where(
            (ci < fl[:, None])[:, :, None], oh, jnp.int16(0))
        return counts, fl.astype(jnp.int32)

    @jax.jit
    def consensus_step(counts, n_placed, ncol, overflow, ev):
        """Packs (best | keep<<3 | overflow<<4 | ev<<5 | coverage<<8)
        into one int32 plane, the batch's single pull."""
        counts = counts.astype(jnp.int32)
        B, T, _ = counts.shape
        ci = jnp.arange(T)[None, :]
        best = jnp.argmax(counts, axis=2)
        bc = jnp.max(counts, axis=2)
        occ = counts.sum(axis=2)
        gaps = n_placed[:, None] - occ
        keep = (bc > gaps) & (ci < ncol[:, None])
        return (best
                | where(keep, 8, 0)
                | where(overflow[:, None], 16, 0)
                | jnp.left_shift(ev, 5)[:, None]
                | jnp.left_shift(bc, 8)).astype(jnp.int32)

    return (gather_step, scores_step, update_step, consensus_step,
            init_step, polish_update, costs)


# --------------------------------------------------------------- driver --


def batch_cap(T: int, WL: int) -> int:
    """Region rows per call: the direction table (2T-1 rows of WL bytes
    per region) is the call's working memory; keep it under 1 GiB of the
    card's 80 GB, and at most 256 regions."""
    cap = (1 << 30) // ((2 * T) * WL)
    b = 8
    while b * 2 <= min(cap, 256):
        b *= 2
    return b


@functools.lru_cache(maxsize=None)
def shared(*args, **kw) -> "DeviceMSA":
    """One DeviceMSA per distinct configuration in a process, so engines
    built one after another (every cli.main call builds one) reuse its
    traced round functions instead of tracing them again."""
    return DeviceMSA(*args, **kw)


class DeviceMSA:
    """Batched profile-POA over fixed (T, W, B) shapes; one pull per batch.

    interpret=True runs the kernel through the Pallas interpreter (CPU
    tests)."""

    def __init__(self, match, mismatch, gap_open, gap_ext, polish=0,
                 buckets=(128, 256, 384, 512, 640, 768, 896, 1024,
                          2048, 4096), mesh=None,
                 gap_open2=None, gap_ext2=None, interpret=False):
        """Buckets are fine-grained below 1024 (DP cost ~2*T^2, so a
        spill pays the full ratio) and coarse above (the banded kernels
        bound rows by the actual qlen+ncol and lanes by the band window).
        The ladder is part of the result's semantics: the host mirror
        (ops/poa_profile.banded_profile_consensus) uses the same one.

        polish: frozen-layout refinement rounds after the sequential pass
        (bit-exact with profile_consensus(..., polish=polish))."""
        self.buckets = tuple(sorted(buckets))
        self.polish = polish
        self.interpret = interpret
        # 1-D 'dp' mesh: region batches shard over it; each card runs the
        # fused round on its own shard under jax.shard_map (no
        # collectives: regions are independent, the reference's pthread
        # fan-out role)
        self.mesh = mesh
        self.mesh_n = 1 if mesh is None else int(mesh.devices.size)
        if gap_open2 is None:
            # single-affine callers: track 2 strictly dominated (same
            # extension, open too large to ever win within one bucket)
            gap_open2 = gap_open + gap_ext * (2 * self.buckets[-1] + 2)
            gap_ext2 = gap_ext
        (self.gather_step, self.scores_step, self.update_step,
         self.consensus_step, self.init_step, self.polish_update,
         self.costs) = _build_jits(
            match, mismatch, gap_open, gap_ext, gap_open2, gap_ext2)
        self._round_fns: Dict[tuple, object] = {}

    def _bucket(self, n: int):
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _sub_b(self, n: int, T: int, W=None) -> int:
        """Per-shard region rows for n regions: 8, 32, 128, ... up to
        batch_cap.  Pad rows cost one backtrack step each in the kernel,
        so coarse rungs keep the compiled shape count low."""
        cap = batch_cap(T, lanes(T) if W is None else W)
        if self.interpret:
            cap = 8
        per = -(-max(1, n) // self.mesh_n)
        b = 8
        while b < per and b < cap:
            b *= 4
        return min(b, cap)

    def _round(self, T: int, W, Bs: int):
        """Fused unit round (scores + DP/backtrack + update) as ONE jit;
        k arrives as a traced scalar — no per-k recompile.

        W set swaps in the W-lane windowed DP and threads an `ev`
        first-event state through the rounds: per region, 0 = clean,
        1 = the path of some unit touched the band edge, 2 = the profile
        overflowed the bucket — recording whichever happened FIRST (and
        touch before overflow within one round), which is exactly the
        order the sequential host oracle (banded_profile_consensus)
        encounters them, so the driver's retry walk matches the host's
        bit-for-bit."""
        key = (T, W, Bs)
        if key in self._round_fns:
            return self._round_fns[key]
        banded = W is not None
        WL = lanes(T) if W is None else W
        NL = -(-(2 * T + 1) // 128) * 128
        dp_bt = functools.partial(
            _dp_bt_call, T=T, W=W, WL=WL, NL=NL, costs=self.costs,
            interpret=self.interpret)

        def dp(counts, n_placed, ncol, unit_k, qlen_k):
            zq, col = self.scores_step(counts, n_placed, ncol, unit_k, WL=WL)
            return dp_bt(zq, col, jnp.stack([qlen_k, ncol], axis=1))

        def round_fn(counts, n_placed, ncol, overflow, ev,
                     unit_k, qlen_k, active):
            ops_c, nst = dp(counts, n_placed, ncol, unit_k, qlen_k)
            counts2, n_placed2, ncol2, overflow2 = self.update_step(
                counts, n_placed, ncol, overflow, unit_k, qlen_k, active,
                ops_c, nst[:, 0:1])
            if banded:
                tch = (nst[:, 1] > 0) & active
                ovf_new = overflow2 & ~overflow
                ev = where(
                    ev != 0, ev,
                    where(tch, 1, where(ovf_new, 2, 0)))
            return counts2, n_placed2, ncol2, overflow2, ev

        def polish_round_fn(votes, counts, n_placed, ncol, ev,
                            unit_k, qlen_k, active):
            ops_c, nst = dp(counts, n_placed, ncol, unit_k, qlen_k)
            votes2 = self.polish_update(votes, ncol, active, unit_k,
                                        ops_c, nst[:, 0:1])
            if banded:
                tch = (nst[:, 1] > 0) & active
                ev = where(ev != 0, ev, where(tch, 1, 0))
            return votes2, ev

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            s = NamedSharding(self.mesh, P("dp"))

            def _smap(fn, n_in, n_out):
                m = jax.shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(P("dp"),) * n_in,
                    out_specs=(P("dp"),) * n_out,
                    check_vma=False,
                )
                return jax.jit(m, in_shardings=(s,) * n_in,
                               out_shardings=(s,) * n_out)

            round_fn = _smap(round_fn, 8, 5)
            polish_round_fn = _smap(polish_round_fn, 8, 2)
        else:
            round_fn = jax.jit(round_fn)
            polish_round_fn = jax.jit(polish_round_fn)

        self._round_fns[key] = (round_fn, polish_round_fn, Bs * self.mesh_n)
        return self._round_fns[key]

    def consensus_batch(
        self, regions: List[List[np.ndarray]]
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(cons_bases, coverage)] per region; None marks a region past
        the largest bucket (the caller's counted host cap)."""
        from ..utils.metrics import METRICS

        out: List = [None] * len(regions)
        # (region index, min bucket, band-ladder rung)
        todo: List[Tuple[int, int, int]] = []
        spread = [0] * len(regions)
        for ri, units in enumerate(regions):
            cap = max(len(u) for u in units)
            spread[ri] = cap - min(len(u) for u in units)
            # 1.2x column-growth margin (profile growth on 10%-error R2C2
            # units: mean 1.15, max 1.17); a region whose profile
            # outgrows its bucket overflows and retries one bucket up
            todo.append((ri, int(cap * 1.2) + 8, 0))

        while todo:
            by_bucket: Dict[Tuple[int, int | None], List] = {}
            for ri, need, rung in todo:
                b = self._bucket(need)
                if b is not None:
                    rungs = band_ladder(b, spread[ri])
                    W = rungs[min(rung, len(rungs) - 1)]
                    by_bucket.setdefault((b, W), []).append((ri, rung))
            todo = []
            # enqueue every batch's rounds (all async), then pull
            launched = []
            with METRICS.timed("msa_enqueue"):
                for (T, W), entries in by_bucket.items():
                    lo = 0
                    while lo < len(entries):
                        Bs = self._sub_b(len(entries) - lo, T, W)
                        round_fn, polish_round_fn, B = self._round(T, W, Bs)
                        part = entries[lo:lo + B]
                        dev = self._enqueue_batch(
                            [regions[i] for i, _ in part], T, B,
                            round_fn, polish_round_fn, W)
                        launched.append((part, T, W, dev))
                        lo += B
            with METRICS.timed("msa_pull"):
                for _, _, _, dev in launched:
                    dev.copy_to_host_async()
                for part, T, W, dev in launched:
                    res = self._collect_batch(dev, len(part), W)
                    for (i, rung), r in zip(part, res):
                        if r is None:
                            # overflow: bucket up, ladder restarts
                            METRICS.add("msa_retry_ovf")
                            todo.append((i, T + 1, 0))
                        elif isinstance(r, str):
                            # band touch: same bucket, next rung
                            METRICS.add("msa_retry_touch")
                            todo.append((i, T, rung + 1))
                        else:
                            out[i] = r
        return out

    def _enqueue_batch(self, regs, T, B, round_fn, polish_round_fn, W=None):
        """Dispatches every unit round of one region batch; returns the
        still-on-device packed consensus plane — no host pull."""
        from ..utils.metrics import METRICS

        U = max(len(units) for units in regs)
        units_arr = np.full((B, U, T), 4, np.uint8)
        ulen = np.zeros((B, U), np.int32)
        nunits = np.ones(B, np.int32)
        for i, units in enumerate(regs):
            nunits[i] = len(units)
            for k, u in enumerate(units):
                L = min(len(u), T)
                units_arr[i, k, :L] = u[:L]
                ulen[i, k] = max(1, L)

        units_dev = jnp.asarray(units_arr)
        ulen_dev = jnp.asarray(ulen)
        counts, ncol = self.init_step(units_dev, ulen_dev)
        n_placed = jnp.ones(B, jnp.int32)
        overflow = jnp.zeros(B, bool)
        nunits_dev = jnp.asarray(nunits)
        ev = jnp.zeros(B, jnp.int32)
        max_units = int(nunits.max())
        # cells: each unit round sweeps a [B, T, band] DP
        METRICS.add(
            "msa_cells",
            float(B) * T * (T if W is None else W)
            * (max_units - 1 + self.polish * max_units))
        METRICS.add("msa_batches")
        for k in range(1, max_units):
            unit_k, qlen_k, active = self.gather_step(
                units_dev, ulen_dev, nunits_dev, k)
            counts, n_placed, ncol, overflow, ev = round_fn(
                counts, n_placed, ncol, overflow, ev,
                unit_k, qlen_k, active)

        for _ in range(self.polish):
            # frozen-layout refinement: the round reads the SAME counts
            # every k, so sub/wdel stay frozen while the unit gather walks
            # k = 0..max-1 (k=0 realigns the first unit too)
            votes = jnp.zeros_like(counts)
            for k in range(max_units):
                unit_k, qlen_k, active = self.gather_step(
                    units_dev, ulen_dev, nunits_dev, k)
                votes, ev = polish_round_fn(
                    votes, counts, n_placed, ncol, ev,
                    unit_k, qlen_k, active)
            counts = votes
            n_placed = nunits_dev

        return self.consensus_step(counts, n_placed, ncol, overflow, ev)

    def _collect_batch(self, dev, R, W=None):
        banded = W is not None
        packed = np.asarray(dev)
        out = []
        for i in range(R):
            row = packed[i]
            ev_i = (row[0] >> 5) & 3
            if banded and ev_i == 1:
                out.append("touch")     # band edge: next-rung retry
                continue
            if (banded and ev_i == 2) or row[0] & 16:
                out.append(None)        # overflow -> bucket-up retry
                continue
            kp = (row & 8) != 0
            out.append(((row[kp] & 7).astype(np.uint8),
                        (row[kp] >> 8).astype(np.int64)))
        return out
