/* Small-window global affine alignment — native host kernel.
 *
 * Exact-semantics implementation of the (iden_n, t_left_ext) contract of
 * ops/ksw2.py global_with_cigar + backtrack_left_end (the NumPy oracle of
 * reference ksw2/ksw2_extz2_sse.c:26-303 + src/ksw2_align.c:88-151),
 * written against that oracle's arithmetic: the Suzuki-Kasahara difference
 * recurrence over anti-diagonals with the reference's direction-byte
 * tie-breaks (diagonal beats E on ties, E beats F), cell clamp
 * z <= MAX_SC, the ksw_backtrack is_rot=1 state machine, M-run identity
 * counting, and the right-to-left split projection (q_left_ext query
 * bases consumed -> target bases crossed).
 *
 * Why host-side: the partition walk's alignments are TINY (mean ~34 bp,
 * max ~100 on the headline workload) and strictly sequential per chain —
 * a device dispatch round costs far more than the whole
 * 34x34 DP is ~2 us of scalar C. Routing them here removes EVERY
 * partition-stage device round trip; the device keeps the large batched DP
 * (MSA, aveMatch identities, boundary extensions).
 *
 * Scoring is the reference's hard-coded model (src/ksw2_align.c:11-17):
 * match +1, mismatch -2, gap open 2, gap ext 1, N-vs-anything -1.
 *
 * Build: compiled into libchainx.so next to chainx.c (native/__init__.py).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MATCH_SC 1
#define MIS_SC (-2)
#define GAP_OPEN 2
#define GAP_EXT 1
#define SC_N (-GAP_EXT)
#define QE (GAP_OPEN + GAP_EXT)
#define QE2 (2 * QE)
#define MAX_SC (MATCH_SC + QE2)

/* One alignment: fills *iden (identical bases along M runs) and *tleft
 * (target bases consumed walking the cigar right-to-left through qle
 * query bases; qle > qlen mirrors the device kernel: tleft = tlen).
 * scratch: caller-provided, at least
 *   4*tlen*4 bytes (u,v,x,y int32) + (qlen+tlen-1)*tlen bytes (p). */
static void one_global(
    const uint8_t *q, int64_t qlen, const uint8_t *t, int64_t tlen,
    int64_t qle, uint8_t *scratch, int64_t *iden_out, int64_t *tleft_out)
{
    if (qlen <= 0 || tlen <= 0) {
        *iden_out = 0;
        *tleft_out = qle > qlen ? (tlen > 0 ? tlen : 0) : 0;
        return;
    }
    int32_t *u = (int32_t *)scratch;
    int32_t *v = u + tlen;
    int32_t *x = v + tlen;
    int32_t *y = x + tlen;
    uint8_t *p = (uint8_t *)(y + tlen);
    memset(u, 0, 4 * tlen * 4);
    int64_t n_rows = qlen + tlen - 1;

    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t st0 = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
        int64_t en0 = r < tlen - 1 ? r : tlen - 1;
        if (en0 == r) {              /* brand-new diagonal cell boundary */
            y[r] = 0;
            u[r] = r ? GAP_OPEN : 0;
        }
        /* previous-row (t-1) neighbors enter via carried temporaries */
        int32_t xm1, vm1;
        if (st0 == 0) {
            xm1 = 0;
            vm1 = r ? GAP_OPEN : 0;
        } else {
            xm1 = x[st0 - 1];
            vm1 = v[st0 - 1];
        }
        uint8_t *pr = p + r * tlen;
        for (int64_t ti = st0; ti <= en0; ++ti) {
            uint8_t tb = t[ti], qb = q[r - ti];
            int32_t s = (tb == 4 || qb == 4) ? SC_N
                        : (tb == qb ? MATCH_SC : MIS_SC);
            int32_t a = xm1 + vm1;
            int32_t b = y[ti] + u[ti];
            int32_t z = s + QE2;
            uint8_t d = a > z;
            if (a > z) z = a;
            if (b > z) { d = 2; z = b; }
            if (z > MAX_SC) z = MAX_SC;
            int32_t u_old = u[ti];
            int32_t x_old = x[ti], v_old = v[ti];
            u[ti] = z - vm1;
            v[ti] = z - u_old;
            int32_t z2 = z - GAP_OPEN;
            int32_t a2 = a - z2, b2 = b - z2;
            x[ti] = a2 > 0 ? a2 : 0;
            y[ti] = b2 > 0 ? b2 : 0;
            if (a2 > 0) d |= 0x08;
            if (b2 > 0) d |= 0x10;
            pr[ti] = d;
            xm1 = x_old;
            vm1 = v_old;
        }
    }

    /* backtrack (ksw2/ksw2.h:119-152, is_rot=1), fused with identity
     * counting and the right-to-left qle projection (src/ksw2_align.c:
     * 62-115).  Step-wise t_left rule (equivalent to the per-run walk):
     * entering any query-consuming step with q_remain == 0 returns; an M
     * step then consumes one of each and returns when q_remain hits 0
     * (its target INcluded); an I step consumes query only and returns
     * when q_remain hits 0 (target EXcluded); D steps accumulate. */
    int64_t iden = 0;
    int64_t tleft = 0;
    int tleft_set = 0;
    int64_t q_remain = qle;
    if (qle > qlen) {
        tleft = tlen;
        tleft_set = 1;
    } else if (qle <= 0) {
        q_remain = 0;                 /* trailing-D count semantics */
    }
    int64_t i = tlen - 1, j = qlen - 1;
    int state = 0;
    while (i >= 0 && j >= 0) {
        int tmp = p[(i + j) * tlen + i];
        if (state == 0) state = tmp & 7;
        else if (!((tmp >> (state + 2)) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (state == 0) {             /* M: consumes query + target */
            if (!tleft_set) {
                if (q_remain == 0) tleft_set = 1;
                else {
                    --q_remain;
                    ++tleft;
                    if (q_remain == 0) tleft_set = 1;
                }
            }
            if (q[j] == t[i]) ++iden;
            --i;
            --j;
        } else if (state == 1) {      /* D: consumes target */
            if (!tleft_set) ++tleft;
            --i;
        } else {                      /* I: consumes query */
            if (!tleft_set) {
                if (q_remain == 0) tleft_set = 1;
                else {
                    --q_remain;
                    if (q_remain == 0) tleft_set = 1;
                }
            }
            --j;
        }
    }
    if (i >= 0 && !tleft_set)         /* leftmost boundary D run */
        tleft += i + 1;
    if (j >= 0 && !tleft_set) {       /* leftmost boundary I run */
        if (j + 1 >= q_remain) tleft_set = 1;
        else tleft = tlen;            /* q_remain unmatched: kernel rule */
    }
    *iden_out = iden;
    *tleft_out = tleft;
}

/* Single-request entry: returns (iden << 20) | (tleft + 1) packed (tleft
 * fits: windows are bounded by the caller's host cap, which the Python
 * layer clamps below 2^20; -1 never occurs in the low field).  Returns
 * -1 on scratch allocation failure (all legit values are >= 0) so the
 * caller can fall back to its catchable-oracle path.  The scratch
 * mallocs per call (~100 ns — thread-safe, negligible vs the DP). */
int64_t th_global_tleft(
    const uint8_t *q, int64_t qlen, const uint8_t *t, int64_t tlen,
    int64_t qle)
{
    int64_t iden = 0, tleft = 0;
    if (qlen > 0 && tlen > 0) {
        int64_t sz = 4 * tlen * 4 + (qlen + tlen - 1) * tlen;
        uint8_t *scratch = (uint8_t *)malloc(sz);
        if (!scratch)
            return -1;
        one_global(q, qlen, t, tlen, qle, scratch, &iden, &tleft);
        free(scratch);
    } else {
        one_global(q, qlen, t, tlen, qle, NULL, &iden, &tleft);
    }
    return (iden << 20) | (tleft + 1);
}

/* Whole right-hand partition walk (reference src/partition.c:236-273;
 * exact port of the ops/partition.py partition_walk_right generator with
 * the alignments resolved inline by one_global).  The walk's Python scan
 * touches O(cells) entries per step (~1600 cells/chain on the headline
 * workload) — in C the whole stage is ~50 us/read.
 *
 * Returns the number of positions written to out, or -1 when the walk
 * must be redone by the generic path: an alignment window exceeding
 * `cap`, an out-of-bounds window, more than 4n+64 steps, or an out
 * buffer overflow.  The left walk is trivially empty in the live
 * pipeline (est_ch_i == 0 always: src/tandem_chain.c:398 set_start_period
 * is the only est setter called), so only the right walk is ported. */
int64_t th_walk_right(
    const uint8_t *bseq, int64_t slen,
    const int64_t *starts, const int64_t *ends, int64_t n,
    int64_t est_start, int64_t est_period,
    int64_t k, double max_div, int64_t cap,
    int64_t *out, int64_t out_cap)
{
    if (n < 1)
        return 0;
    double thr_c = 1.0 - max_div;
    int64_t last_start = starts[n - 1];
    int64_t np_ = 0;
    int64_t ch_i = 0, s = est_start, e = est_start + est_period;
    int64_t steps = 0, max_steps = 4 * n + 64;
    uint8_t *scratch =
        (uint8_t *)malloc(4 * cap * 4 + (2 * cap - 1) * cap);
    if (!scratch)
        return -1;
    while (ch_i < n - 1 && e <= last_start) {
        if (++steps > max_steps)
            goto fail;
        int64_t s1 = s, e1 = e;
        int event = 0;
        for (int64_t i = ch_i + 1; i < n; ++i) {
            int64_t s2 = starts[i], e2 = ends[i];
            if (s2 == e) {                    /* anchors abut: free split */
                if (np_ + 1 > out_cap)
                    goto fail;
                out[np_++] = e2;
                ch_i = i; s = s2; e = e2;
                event = 1;
                break;
            } else if (s2 > e) {              /* align the flanking windows */
                int64_t qlen = s2 - s1 + k, tlen = e2 - e1 + k;
                int64_t qoff = s1 - k + 1, toff = e1 - k + 1;
                if (qlen > cap || tlen > cap || qlen < 1 || tlen < 1 ||
                    qoff < 0 || toff < 0 ||
                    qoff + qlen > slen || toff + tlen > slen)
                    goto fail;
                int64_t iden, tl;
                one_global(bseq + qoff, qlen, bseq + toff, tlen, s2 - e,
                           scratch, &iden, &tl);
                int64_t mn = qlen < tlen ? qlen : tlen;
                if ((double)iden >= (double)mn * thr_c) {
                    s = e;
                    int64_t e_new = e2 - tl;
                    if (e_new == s) { ch_i = n; event = 1; break; }
                    e = e_new;
                    if (np_ + 1 > out_cap)
                        goto fail;
                    out[np_++] = e;
                    ch_i = i - 1;             /* reference quirk: rescan i */
                } else {                      /* separator + restart */
                    if (np_ + 3 > out_cap)
                        goto fail;
                    out[np_++] = -1; out[np_++] = s2; out[np_++] = e2;
                    ch_i = i; s = s2; e = e2;
                }
                event = 1;
                break;
            } else {                          /* passed cell */
                s1 = s2; e1 = e2;
            }
        }
        if (!event)
            break;     /* scan exhausted => e > last_start next check */
    }
    free(scratch);
    return np_;
fail:
    free(scratch);
    return -1;
}

/* Batch entry: sequences packed into one byte buffer per side, items
 * addressed by (offset, length); answers land in iden[]/tleft[].  Items
 * whose O((qlen+tlen)*tlen) scratch cannot be allocated get iden = -1
 * (legit idens are >= 0) so the caller reroutes them to its
 * catchable-oracle path instead of dereferencing NULL. */
void th_global_tleft_batch(
    const uint8_t *qbuf, const int64_t *qoff, const int64_t *qlen,
    const uint8_t *tbuf, const int64_t *toff, const int64_t *tlen,
    const int64_t *qle, int64_t n, int64_t *iden, int64_t *tleft)
{
    /* one scratch allocation sized for the largest item; if that fails,
     * retry per-item so one oversize request can't starve the rest */
    int64_t need = 0;
    for (int64_t it = 0; it < n; ++it) {
        int64_t ql = qlen[it], tl = tlen[it];
        if (ql <= 0 || tl <= 0) continue;
        int64_t sz = 4 * tl * 4 + (ql + tl - 1) * tl;
        if (sz > need) need = sz;
    }
    uint8_t *scratch = need ? (uint8_t *)malloc(need) : NULL;
    for (int64_t it = 0; it < n; ++it) {
        int64_t ql = qlen[it], tl = tlen[it];
        uint8_t *sc = scratch, *own = NULL;
        if (ql > 0 && tl > 0 && !sc) {
            own = (uint8_t *)malloc(4 * tl * 4 + (ql + tl - 1) * tl);
            if (!own) {
                iden[it] = -1;
                tleft[it] = 0;
                continue;
            }
            sc = own;
        }
        one_global(qbuf + qoff[it], ql, tbuf + toff[it], tl,
                   qle[it], sc, &iden[it], &tleft[it]);
        if (own) free(own);
    }
    if (scratch) free(scratch);
}
