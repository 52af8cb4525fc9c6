"""Wavefront affine-gap DP on the GPU: Pallas kernels through Triton.

Same recurrence and tie-break semantics as the NumPy oracle ops/ksw2.py
(the reference's ksw2/ksw2_extz2_sse.c evaluated exactly).  One program
aligns one problem: it walks that problem's own qlen + tlen - 1
anti-diagonals in a loop inside the kernel, keeps the Suzuki-Kasahara
difference state (u, v, x, y) and the annotation planes on chip for the
whole loop, and writes back a few words.  The plain-XLA form of the same
DP (ops/ksw2_jax.py) runs one small device step per anti-diagonal, so its
time follows the diagonal count rather than the cell count.

* **Forward-carried backtrack annotations**: the 'global' variant carries
  (iden_n, t_left_ext) through the DP — for each cell and each backtrack
  entry state (H, E-run, F-run) it propagates the annotation of the path
  the reference backtracker (ksw2/ksw2.h:119-152, is_rot=1) would walk if
  it entered that cell in that state. The direction decisions d/bit08/bit10
  are mirrored forward instead of stored, so the direction tensor and the
  backtrack pass disappear: output is one packed word per problem.
* The 'ext' variant reproduces the exact 32-bit H row-max scan semantics
  (SIMD tie order of ksw2_extz2_sse.c:224-260) via per-lane (bestH, bestR)
  accumulators + a post-pass: bestR[t] = first row where lane t reached
  bestH[t]; the winning row r* = min bestR among bestH == max, and the
  in-row tie order (en0 first, then the 4-lane scan, then the remainder)
  is reapplied analytically for row r*.

Annotation correctness: A_s(c) = annotation of the backtrack suffix from
cell c entered in state s:
  A0(c) = d==0 ? A0(i-1,j-1)+M(c) : d==1 ? A1(i-1,j) : A2(i,j-1)+I(c)
  A1(c) = bit08(c) ? A1(i-1,j) : A0(c)      (D steps carry no annotation)
  A2(c) = bit10(c) ? A2(i,j-1)+I(c) : A0(c)
M(c) adds identity when q[j]==t[i]; the t_left projection is set by the
step consuming query index qlen-max(qle,1) (ops/ksw2.backtrack_left_end:
an M run returns t_left + q_remain — including the exhausting base's
target — while an I run returns t_left without it; qle==0 stops at the
last query-consuming step, excluding its target).  Tail cigar runs
(ksw2.h boundary pushes) enter as out-of-grid boundary values.  iden and
tleft pack into one int32 lane (iden << 14 | tleft+1).

Triton has no lane shift on values, so each row's one-lane shift goes
through memory: the planes that need their left neighbour are stored to a
per-program scratch row at offset one, the block synchronises, and they
are read back at offset zero.  The scratch is double-buffered by row
parity, so one barrier per row suffices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .ksw2 import GAP_EXT, GAP_OPEN, MATCH_SC, MIS_SC

NEG_INF32 = -(1 << 30)
DEFAULT_SCORES = (MATCH_SC, MIS_SC, GAP_OPEN, GAP_EXT)

TLB = 14                      # t_left field width (tl+1; 0 = unset)
TLMASK = (1 << TLB) - 1


def lanes(n: int) -> int:
    """Lanes of one program: Triton tensors are powers of two."""
    return max(128, 1 << (max(1, int(n)) - 1).bit_length())


def num_warps(TL: int) -> int:
    """Warps per program: ~256 lanes a warp keeps the eleven int32 state
    planes of one problem near 100 registers a thread (Hopper allows 255;
    a 512-thread block may still use 128 each)."""
    return int(min(16, max(4, TL // 256)))


def where(c, a, b):
    """jnp.where for kernel code: Python-int branches are pinned to int32
    (Triton's select lowering would give a weak literal the predicate's
    type)."""
    return jnp.where(c, jnp.int32(a) if isinstance(a, int) else a,
                     jnp.int32(b) if isinstance(b, int) else b)


def barrier(interpret: bool) -> None:
    """Block-wide barrier between the scratch store and its reload (the
    interpreter runs a program's lanes as one array, so needs none)."""
    if not interpret:
        pltr.debug_barrier()


def shift_right(scr_ref, b, r, planes, TL, interpret):
    """[p[t-1] for p in planes]; lane 0 is undefined (callers overwrite
    it).  scr_ref: [B, 2, n_planes, TL + 1] per-program scratch."""
    par = jax.lax.bitwise_and(r, jnp.int32(1))
    for k, p in enumerate(planes):
        scr_ref[b, par, k, pl.ds(1, TL)] = p
    barrier(interpret)
    return [scr_ref[b, par, k, pl.ds(0, TL)] for k in range(len(planes))]


def reversed_query(q: jnp.ndarray, TL: int) -> jnp.ndarray:
    """[B, LQ] -> [B, LQ + 2TL - 1] int32 with zq[S + t] = q[r - t] for
    S = LQ + TL - 1 - r: the query along anti-diagonal r is one
    contiguous load (4 = N outside the query)."""
    qf = jnp.pad(q.astype(jnp.int32), ((0, 0), (TL - 1, TL)),
                 constant_values=4)
    return qf[:, ::-1]


def _dp_row(r, qb, tb, x_sh, v_sh, u, v, x, y, qlen, tlen, ti, scores):
    """One anti-diagonal of the Suzuki-Kasahara difference recurrence.
    Purely elementwise.  Returns (mask, d, bit08, bit10, u_new, v_new,
    next (u, v, x, y))."""
    MATCH, MIS, GO, GE = scores
    QE2_ = 2 * (GO + GE)
    MAXSC = MATCH + QE2_
    st0 = jnp.maximum(0, r - qlen + 1)
    en0 = jnp.minimum(tlen - 1, r)
    active = r < qlen + tlen - 1
    mask = (ti >= st0) & (ti <= en0) & active

    is_n = (tb == 4) | (qb == 4)
    s = where(is_n, -GE, where(tb == qb, MATCH, MIS))
    bq = where(r > 0, GO, 0)
    is_r = ti == r
    y_b = where(is_r, 0, y)
    u_b = where(is_r, bq, u)
    x_sh = where(ti == 0, 0, x_sh)
    v_sh = where(ti == 0, bq, v_sh)

    a = x_sh + v_sh
    b = y_b + u_b
    z = s + QE2_
    d = where(a > z, 1, 0)
    z = jnp.maximum(z, a)
    d = where(b > z, 2, d)
    z = jnp.maximum(z, b)
    z = jnp.minimum(z, MAXSC)
    u_new = z - v_sh
    v_new = z - u_b
    z2 = z - GO
    a2 = a - z2
    b2 = b - z2
    nxt = (where(mask, u_new, u), where(mask, v_new, v),
           where(mask, jnp.maximum(a2, 0), x),
           where(mask, jnp.maximum(b2, 0), y))
    return mask, d, a2 > 0, b2 > 0, u_new, v_new, nxt


def _problem(zq_ref, tg_ref, meta_ref, b, LQ, TL):
    qlen = meta_ref[b, 0]
    tlen = meta_ref[b, 1]
    ti = jax.lax.broadcasted_iota(jnp.int32, (TL,), 0)
    tb = tg_ref[b, pl.ds(0, TL)]

    def qrow(r):
        return zq_ref[b, pl.ds(LQ + TL - 1 - r, TL)]

    return qlen, tlen, ti, tb, qrow


# ---------------------------------------------------------------- global --


def _global_kernel(zq_ref, tg_ref, meta_ref, out_ref, scr_ref, *,
                   LQ: int, TL: int, scores: tuple, with_tl: bool,
                   interpret: bool):
    b = pl.program_id(0)
    qlen, tlen, ti, tb, qrow = _problem(zq_ref, tg_ref, meta_ref, b, LQ, TL)
    qle = meta_ref[b, 2]
    # the walk of backtrack_left_end returns at the step consuming query
    # index qlen-qle (M: including its target; I: excluding); qle==0 stops
    # at the LAST query-consuming step, excluding its target either way
    jS = qlen - jnp.maximum(qle, 1)
    has_q = qle > 0

    def row(r, st):
        # aXp2: written at row r-2 (same parity as r); aXp1: at row r-1
        u, v, x, y, a0p2, a0p1, a1p2, a1p1, a2p2, a2p1, acc = st
        qb = qrow(r)
        x_s, v_s, a0_s, a1_s = shift_right(
            scr_ref, b, r, (x, v, a0p2, a1p1), TL, interpret)
        mask, d, bit08, bit10, _, _, (u, v, x, y) = _dp_row(
            r, qb, tb, x_s, v_s, u, v, x, y, qlen, tlen, ti, scores)
        eq = where(qb == tb, 1, 0)
        if with_tl:
            j = r - ti
            is_jS = j == jS
            # out-of-grid predecessor boundaries (tail cigar runs)
            pm_b0 = where(jS <= r - 1, (tlen + 1) & TLMASK, 0)
            pd_b0 = where(jS <= r, (tlen + 1) & TLMASK, 0)
            P_M = where(ti == r, 0, where(ti == 0, pm_b0, a0_s))
            P_D = where(ti == 0, pd_b0, a1_s)
            P_I = where(ti == r, 0, a2p1)
            set_m = (where(has_q, tlen - ti, tlen - 1 - ti) + 1) & TLMASK
            set_i = (where(has_q, tlen - ti - 1, tlen - 1 - ti)
                     + 1) & TLMASK
            M_step = (((P_M >> TLB) + eq) << TLB) | where(
                is_jS, set_m, P_M & TLMASK)
            D_step = P_D
            I_step = (P_I & ~TLMASK) | where(is_jS, set_i, P_I & TLMASK)
        else:
            # iden-only variant (run_giden — aveMatch — never reads
            # tleft): annotations carry the bare identity count
            M_step = where((ti == r) | (ti == 0), 0, a0_s) + eq
            D_step = where(ti == 0, 0, a1_s)
            I_step = where(ti == r, 0, a2p1)
        A0 = where(d == 0, M_step, where(d == 1, D_step, I_step))
        A1 = where(bit08, D_step, A0)
        A2 = where(bit10, I_step, A0)
        hit = (r == qlen + tlen - 2) & (ti == tlen - 1) & mask
        return (u, v, x, y,
                a0p1, where(mask, A0, a0p2),
                a1p1, where(mask, A1, a1p2),
                a2p1, where(mask, A2, a2p2),
                where(hit, A0, acc))

    z = jnp.zeros((TL,), jnp.int32)
    st = jax.lax.fori_loop(0, qlen + tlen - 1, row, (z,) * 11)
    out_ref[b, 0] = jnp.max(st[10])


# ------------------------------------------------------------------- ext --


def _ext_kernel(zq_ref, tg_ref, meta_ref, besth_ref, bestr_ref, sacc_ref,
                scr_ref, *, LQ: int, TL: int, scores: tuple,
                interpret: bool):
    QE_ = scores[2] + scores[3]
    b = pl.program_id(0)
    qlen, tlen, ti, tb, qrow = _problem(zq_ref, tg_ref, meta_ref, b, LQ, TL)

    def row(r, st):
        u, v, x, y, H, bh, br, sacc = st
        qb = qrow(r)
        x_s, v_s, H_sh = shift_right(scr_ref, b, r, (x, v, H), TL,
                                     interpret)
        mask, _, _, _, u_n, v_n, (u, v, x, y) = _dp_row(
            r, qb, tb, x_s, v_s, u, v, x, y, qlen, tlen, ti, scores)
        en0 = jnp.minimum(tlen - 1, r)
        # 32-bit H recurrence (ksw2_extz2_sse.c:224-266), elementwise:
        # H[en0] = H_prev[en0-1] + u[en0] - QE; H[en0]@en0==0 =
        # H_prev[0] + v[0] - QE; H[t<en0] += v - QE
        h_new = where(
            ti == en0,
            where(en0 > 0, H_sh + u_n - QE_, H + v_n - QE_),
            H + v_n - QE_)
        h_new = where((r == 0) & (ti == 0), v_n - QE_ - QE_, h_new)
        H1 = where(mask, h_new, H)
        # per-lane running best with first-improving row (strict >)
        upd = mask & (H1 > bh)
        hit = (r == qlen + tlen - 2) & (ti == tlen - 1) & mask
        return (u, v, x, y, H1, where(upd, H1, bh),
                where(upd, r, br), where(hit, H1, sacc))

    z = jnp.zeros((TL,), jnp.int32)
    init = (z, z, z, z, jnp.full((TL,), NEG_INF32, jnp.int32), z,
            jnp.full((TL,), 0x7FFFFFF, jnp.int32),
            jnp.full((TL,), NEG_INF32, jnp.int32))
    st = jax.lax.fori_loop(0, qlen + tlen - 1, row, init)
    besth_ref[b, pl.ds(0, TL)] = st[5]
    bestr_ref[b, pl.ds(0, TL)] = st[6]
    sacc_ref[b, pl.ds(0, TL)] = st[7]


def _ext_post(besth, bestr, sacc, qlen, tlen):
    """Reference row-scan tie order for the winning row r*
    (ksw2_extz2_sse.c:229-260 / ops/ksw2._row_max_scan)."""
    T = besth.shape[1]
    ti = jnp.arange(T)[None, :]
    qlen1 = qlen[:, None]
    tlen1 = tlen[:, None]
    M = jnp.max(besth, axis=1, keepdims=True)
    is_max = besth == M
    BIGSENT = jnp.int32(0x7FFFFFF)
    rstar = jnp.min(where(is_max, bestr, BIGSENT), axis=1, keepdims=True)
    st0 = jnp.maximum(0, rstar - qlen1 + 1)
    en0 = jnp.minimum(tlen1 - 1, rstar)
    en1 = st0 + (en0 - st0) // 4 * 4
    cand = is_max & (bestr == rstar)
    at_en0 = jnp.any(cand & (ti == en0), axis=1, keepdims=True)
    BIGI = jnp.int32(1 << 20)
    lane = where(ti >= st0, (ti - st0) % 4, 0)
    in_vec = cand & (ti >= st0) & (ti < en1)
    vec_key = jnp.min(where(in_vec, lane * BIGI + ti, BIGSENT),
                      axis=1, keepdims=True)
    in_rem = cand & (ti >= en1) & (ti < en0)
    rem_t = jnp.min(where(in_rem, ti, BIGSENT), axis=1, keepdims=True)
    max_t = where(
        at_en0, en0,
        where(vec_key != BIGSENT, vec_key % BIGI,
              where(rem_t != BIGSENT, rem_t, en0)))
    found = M[:, 0] > 0
    bmax = where(found, M[:, 0], 0)
    bmax_t = where(found, max_t[:, 0], -1)
    bmax_q = where(found, rstar[:, 0] - max_t[:, 0], -1)
    return bmax, bmax_t, bmax_q, jnp.max(sacc, axis=1)


# ------------------------------------------------------------ public API --


def _call(kern, n_out_planes, q, t, meta, TL, n_shift, interpret):
    B, LQ = q.shape
    zq = reversed_query(q, TL)
    tg = jnp.pad(t.astype(jnp.int32), ((0, 0), (0, TL - t.shape[1])),
                 constant_values=4)
    outs = [jax.ShapeDtypeStruct((B, w), jnp.int32) for w in n_out_planes]
    outs.append(jax.ShapeDtypeStruct((B, 2, n_shift, TL + 1), jnp.int32))
    res = pl.pallas_call(
        kern,
        grid=(B,),
        out_shape=tuple(outs),
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=num_warps(TL), num_stages=1),
        interpret=interpret,
    )(zq, tg, meta)
    return res[:-1]


def _global_body(q, t, meta, *, TL, scores, with_tl, interpret):
    kern = functools.partial(
        _global_kernel, LQ=q.shape[1], TL=TL, scores=scores,
        with_tl=with_tl, interpret=interpret)
    (packed,) = _call(kern, (1,), q, t, meta, TL, 4, interpret)
    packed = packed[:, 0]
    if not with_tl:
        return packed, jnp.zeros_like(packed)
    iden = packed >> TLB
    tl = (packed & TLMASK) - 1
    tleft = where(meta[:, 2] > meta[:, 0], meta[:, 1], tl)
    return iden, tleft


def _ext_body(q, t, meta, *, TL, scores, interpret):
    kern = functools.partial(_ext_kernel, LQ=q.shape[1], TL=TL,
                             scores=scores, interpret=interpret)
    besth, bestr, sacc = _call(kern, (TL, TL, TL), q, t, meta, TL, 3,
                               interpret)
    return _ext_post(besth, bestr, sacc, meta[:, 0], meta[:, 1])


@functools.lru_cache(maxsize=None)
def _compiled(kind, mesh, TL, scores, with_tl, interpret):
    """jit of one kernel variant; under a 'dp' mesh, jit(shard_map(...))
    over the batch axis — rows are independent, so there are no
    collectives and results stay sharded until the caller's one pull."""
    if kind == "global":
        body = functools.partial(_global_body, TL=TL, scores=scores,
                                 with_tl=with_tl, interpret=interpret)
        n_out = 2
    else:
        body = functools.partial(_ext_body, TL=TL, scores=scores,
                                 interpret=interpret)
        n_out = 4
    if mesh is None:
        return jax.jit(body)
    from jax.sharding import NamedSharding, PartitionSpec as P

    smap = jax.shard_map(body, mesh=mesh, in_specs=(P("dp"),) * 3,
                         out_specs=(P("dp"),) * n_out, check_vma=False)
    s = NamedSharding(mesh, P("dp"))
    return jax.jit(smap, in_shardings=(s,) * 3, out_shardings=(s,) * n_out)


def _mesh():
    from ..parallel.mesh import active_mesh

    return active_mesh()


def _meta(qlen, tlen, qle=None):
    qlen = np.asarray(qlen, np.int32)
    qle = np.zeros_like(qlen) if qle is None else np.asarray(qle, np.int32)
    return np.stack([qlen, np.asarray(tlen, np.int32), qle], axis=1)


def global_batch(q, qlen, t, tlen, qle, scores=DEFAULT_SCORES,
                 iden_only=False, interpret=False):
    """(iden_n, t_left_ext) for a padded batch of global alignments.

    q [B, LQ] / t [B, LT] uint8 (padding 4), lengths >= 1.  Outputs stay
    on device (the caller pulls once per round).  iden_only=True runs
    the leaner annotation variant (tleft returned as zeros) — for callers
    that never read tleft (run_giden / aveMatch)."""
    fn = _compiled("global", _mesh(), lanes(np.shape(t)[1]), tuple(scores),
                   not iden_only, interpret)
    return fn(jnp.asarray(q), jnp.asarray(t),
              jnp.asarray(_meta(qlen, tlen, qle)))


def ext_batch(q, qlen, t, tlen, scores=DEFAULT_SCORES, interpret=False):
    """(max, max_t, max_q, score) for a padded batch of extensions."""
    fn = _compiled("ext", _mesh(), lanes(np.shape(t)[1]), tuple(scores),
                   True, interpret)
    return fn(jnp.asarray(q), jnp.asarray(t),
              jnp.asarray(_meta(qlen, tlen)))
