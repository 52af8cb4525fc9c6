"""Batched affine-gap wavefront DP in JAX (device path of ops/ksw2.py).

The same Suzuki-Kasahara difference recurrence as the NumPy oracle
(reference ksw2/ksw2_extz2_sse.c), vectorized over BOTH the anti-diagonal
and a batch of alignment problems: state arrays are [B, T] int32, the row
loop is a lax.scan, and everything runs under jit: the cpu engine's
alignment path, and the plain-XLA form the GPU kernels were timed against. Alignment problems of different sizes are padded to bucket shapes
(LQ, LT) with per-problem lengths; padded rows/cells are masked.

Two entry points:
  * extz_score_batch: score-only extension — per-problem (max, max_q,
    max_t, score); used for TR boundary extension (gen_cons.c:217-223)
  * extz_global_batch: global alignment — per-problem (score, iden_n,
    t_left_ext); direction bits are kept on device and consumed by a
    vmapped backtrack walk, so neither the DP matrix nor the cigar ever
    leaves the device. iden_n feeds partition acceptance and aveMatch;
    t_left_ext is ksw2_backtrack_left_end (src/ksw2_align.c:88-115)
    evaluated during the walk for a given q_left_ext.

Tie-break parity: the row-max scan reproduces the reference's 4-lane SIMD
artifacts (see ops/ksw2.py:_row_max_scan) with a key-ordering trick: the
winner among equal maxima is H[en0] first, then minimal (lane, t) over the
vectorized range, then the first remainder position.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ksw2 import GAP_EXT, GAP_OPEN, MATCH_SC, MIS_SC

NEG_INF32 = jnp.int32(-(1 << 30))


def _row_scores(tb, qb, scores):
    match, mis, go, ge = scores
    is_n = (tb == 4) | (qb == 4)
    eq = tb == qb
    return jnp.where(is_n, -ge, jnp.where(eq, match, mis)).astype(jnp.int32)


def _row_max_with_ref_ties(H, st0, en0, T):
    """Row max over H[st0..en0] with the reference SIMD scan's tie order:
    en0 wins all ties; else minimal (lane, t) among [st0, en1); else first
    position in [en1, en0). Returns (max_H, max_t)."""
    t = jnp.arange(T, dtype=jnp.int32)
    in_row = (t >= st0) & (t <= en0)
    Hm = jnp.where(in_row, H, NEG_INF32)
    M = jnp.max(Hm)
    h_en0 = H[en0]
    en1 = st0 + (en0 - st0) // 4 * 4
    lane = (t - st0) % 4
    in_vec = (t >= st0) & (t < en1) & (Hm == M)
    # key: smaller is better -> (lane, t)
    BIG = jnp.int32(1 << 20)
    key = jnp.where(in_vec, lane * BIG + t, jnp.int32(0x7FFFFFFF))
    vec_t = jnp.min(key) % BIG
    has_vec = jnp.any(in_vec)
    in_rem = (t >= en1) & (t < en0) & (Hm == M)
    rem_key = jnp.where(in_rem, t, jnp.int32(0x7FFFFFFF))
    rem_t = jnp.min(rem_key)
    has_rem = jnp.any(in_rem)
    max_t = jnp.where(
        h_en0 == M,
        en0,
        jnp.where(has_vec, vec_t, jnp.where(has_rem, rem_t, en0)),
    )
    return M, max_t


def _wavefront_row(carry, r, q, t, qlen, tlen, T, with_dirs,
                   scores=(MATCH_SC, MIS_SC, GAP_OPEN, GAP_EXT)):
    """One anti-diagonal for one problem. carry: (u, v, x, y, H, res)."""
    MATCH, MIS, GO, GE = scores
    QE_ = GO + GE
    QE2_ = 2 * QE_
    MAXSC = MATCH + QE2_
    u, v, x, y, H, best = carry
    st0 = jnp.maximum(0, r - qlen + 1)
    en0 = jnp.minimum(tlen - 1, r)
    n_rows = qlen + tlen - 1
    active = r < n_rows

    ti = jnp.arange(T, dtype=jnp.int32)
    # query index along the diagonal: j = r - t
    qj = jnp.clip(r - ti, 0, q.shape[0] - 1)
    qb = q[qj]
    s = _row_scores(t, qb, scores)

    # boundary injections on previous-row state
    bq = jnp.where(r > 0, GO, 0).astype(jnp.int32)
    y_b = jnp.where(ti == r, 0, y)
    u_b = jnp.where(ti == r, bq, u)
    x_sh = jnp.concatenate([jnp.zeros(1, jnp.int32), x[:-1]])
    v_sh = jnp.concatenate([bq[None], v[:-1]])

    a = x_sh + v_sh
    b = y_b + u_b
    z = s + QE2_
    d = (a > z).astype(jnp.int32)
    z = jnp.maximum(z, a)
    d = jnp.where(b > z, 2, d)
    z = jnp.maximum(z, b)
    z = jnp.minimum(z, MAXSC)
    u_new = z - v_sh
    v_new = z - u_b
    z2 = z - GO
    a2 = a - z2
    b2 = b - z2
    x_new = jnp.maximum(a2, 0)
    y_new = jnp.maximum(b2, 0)
    if with_dirs:
        d = d | jnp.where(a2 > 0, 0x08, 0) | jnp.where(b2 > 0, 0x10, 0)

    mask = (ti >= st0) & (ti <= en0) & active
    u = jnp.where(mask, u_new, u)
    v = jnp.where(mask, v_new, v)
    x = jnp.where(mask, x_new, x)
    y = jnp.where(mask, y_new, y)

    # H recurrence
    h_prev_en0m1 = H[jnp.maximum(en0 - 1, 0)]
    h_en0 = jnp.where(
        en0 > 0, h_prev_en0m1 + u[en0] - QE_, H[0] + v[0] - QE_
    )
    H1 = jnp.where(mask & (ti < en0), H + v - QE_, H)
    H1 = jnp.where(ti == en0, h_en0, H1)
    H1 = jnp.where(r == 0, jnp.where(ti == 0, v - QE_ - QE_, H), H1)
    H = jnp.where(active, H1, H)

    max_H, max_t = _row_max_with_ref_ties(H, st0, en0, T)
    bmax, bmax_t, bmax_q, bscore = best
    upd = active & (max_H > bmax)
    bmax = jnp.where(upd, max_H, bmax)
    bmax_t = jnp.where(upd, max_t, bmax_t)
    bmax_q = jnp.where(upd, r - max_t, bmax_q)
    bscore = jnp.where(
        active & (r == n_rows - 1), H[jnp.maximum(tlen - 1, 0)], bscore
    )
    carry = (u, v, x, y, H, (bmax, bmax_t, bmax_q, bscore))
    dirs = jnp.where(mask, d, 0).astype(jnp.uint8) if with_dirs else jnp.zeros(
        (1,), jnp.uint8
    )
    return carry, dirs


def _extz_one(q, t, qlen, tlen, with_dirs, n_rows,
              scores=(MATCH_SC, MIS_SC, GAP_OPEN, GAP_EXT)):
    T = t.shape[0]
    u = jnp.zeros(T, jnp.int32)
    v = jnp.zeros(T, jnp.int32)
    x = jnp.zeros(T, jnp.int32)
    y = jnp.zeros(T, jnp.int32)
    H = jnp.full(T, NEG_INF32, jnp.int32)
    best = (jnp.int32(0), jnp.int32(-1), jnp.int32(-1), NEG_INF32)
    body = functools.partial(
        _wavefront_row, q=q, t=t, qlen=qlen, tlen=tlen, T=T,
        with_dirs=with_dirs, scores=scores,
    )
    carry, dirs = jax.lax.scan(
        body, (u, v, x, y, H, best), jnp.arange(n_rows, dtype=jnp.int32)
    )
    return carry[5], dirs


def _backtrack_one(dirs, q, t, qlen, tlen, q_left_ext):
    """Device cigar walk (ksw_backtrack, ksw2/ksw2.h:119-152) computing
    iden_n and the backtrack_left_end projection in one pass."""
    i0 = tlen - 1
    j0 = qlen - 1
    max_steps = qlen + tlen

    def cond(st):
        i, j, state, iden, qrem, tleft, frozen, step = st
        return (i >= 0) & (j >= 0)

    def body(st):
        i, j, state, iden, qrem, tleft, frozen, step = st
        tmp = dirs[i + j, i].astype(jnp.int32)
        state = jnp.where(state == 0, tmp & 7, state)
        state = jnp.where(
            (state != 0) & (((tmp >> (state + 2)) & 1) == 0), tmp & 7, state
        )
        is_m = state == 0
        is_d = state == 1  # consumes target
        # identity on M steps
        eq = q[jnp.maximum(j, 0)] == t[jnp.maximum(i, 0)]
        iden = iden + jnp.where(is_m & eq, 1, 0)
        # left-end projection (walks cigar from the right = this order)
        consume_q = is_m | (~is_d)
        consume_t = is_m | is_d
        add_t = (~frozen) & consume_t & (is_m | is_d)
        # M: add t while qrem>0; I: no t; D: add t while not frozen
        add = jnp.where(
            is_m, (~frozen) & (qrem > 0), jnp.where(is_d, ~frozen, False)
        )
        tleft = tleft + jnp.where(add, 1, 0)
        qrem = qrem - jnp.where((~frozen) & consume_q & (qrem > 0), 1, 0)
        frozen = frozen | (qrem <= 0)
        i = i - jnp.where(consume_t, 1, 0)
        j = j - jnp.where(consume_q, 1, 0)
        return (i, j, state, iden, qrem, tleft, frozen, step + 1)

    init = (
        i0,
        j0,
        jnp.int32(0),
        jnp.int32(0),
        q_left_ext,
        jnp.int32(0),
        q_left_ext <= 0,
        jnp.int32(0),
    )
    i, j, state, iden, qrem, tleft, frozen, _ = jax.lax.while_loop(
        cond, body, init
    )
    # trailing first-deletion (i+1 target bases) / first-insertion (j+1)
    tleft = tleft + jnp.where((~frozen) & (i >= 0), i + 1, 0)
    return iden, tleft


@functools.partial(jax.jit, static_argnames=("n_rows", "scores"))
def _score_batch(q, qlen, t, tlen, n_rows, scores):
    f = jax.vmap(
        lambda qq, tt, ql, tl: _extz_one(qq, tt, ql, tl, False, n_rows, scores)[0]
    )
    return f(q, t, qlen, tlen)


@functools.partial(jax.jit, static_argnames=("n_rows", "scores"))
def _global_batch(q, qlen, t, tlen, q_left_ext, n_rows, scores):
    def one(qq, tt, ql, tl, qle):
        best, dirs = _extz_one(qq, tt, ql, tl, True, n_rows, scores)
        iden, tleft = _backtrack_one(dirs, qq, tt, ql, tl, qle)
        return best[3], iden, tleft

    return jax.vmap(one)(q, t, qlen, tlen, q_left_ext)


DEFAULT_SCORES = (MATCH_SC, MIS_SC, GAP_OPEN, GAP_EXT)


def extz_score_batch(q, qlen, t, tlen, scores=DEFAULT_SCORES):
    """Score-only extension for a padded batch.

    q: [B, LQ] uint8, qlen: [B] int32, t: [B, LT] uint8, tlen: [B] int32.
    Returns (max, max_t, max_q, score) arrays, matching ops/ksw2.extz
    with score_only=True.
    """
    n_rows = int(q.shape[1] + t.shape[1] - 1)
    bmax, bmax_t, bmax_q, bscore = _score_batch(
        jnp.asarray(q), jnp.asarray(qlen, jnp.int32), jnp.asarray(t),
        jnp.asarray(tlen, jnp.int32), n_rows, tuple(scores)
    )
    return bmax, bmax_t, bmax_q, bscore  # JAX arrays (async); caller syncs


def extz_global_batch(q, qlen, t, tlen, q_left_ext=None, scores=DEFAULT_SCORES):
    """Global alignment for a padded batch; returns (score, iden_n,
    t_left_ext) arrays. q_left_ext defaults to 0 (projection unused)."""
    B = q.shape[0]
    if q_left_ext is None:
        q_left_ext = np.zeros(B, np.int32)
    n_rows = int(q.shape[1] + t.shape[1] - 1)
    score, iden, tleft = _global_batch(
        jnp.asarray(q), jnp.asarray(qlen, jnp.int32), jnp.asarray(t),
        jnp.asarray(tlen, jnp.int32), jnp.asarray(q_left_ext, jnp.int32),
        n_rows, tuple(scores),
    )
    return score, iden, tleft  # JAX arrays (async); caller syncs
