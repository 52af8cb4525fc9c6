/* Tandem-repeat chaining DP — native host kernel.
 *
 * Exact-semantics implementation of the chaining stage specified by the
 * reference chainer (reference src/tandem_chain.c:290-404): grouped hit DP
 * with the same pruning rules (nearest-group-first scan, iter_n/max_h
 * cutoff, SAME/OVL shortcuts), score ranking with the reference's stable
 * tie order (group desc, j asc), backtrack with overlap dedup that may kill
 * lower-scoring chains, the literal sort_chain index quirk, and first-cell
 * representatives. This is an original implementation written against the
 * behavioral spec established by the Python oracle (ops/chaining.py), which
 * is itself pinned to the reference by golden tests.
 *
 * The chain DP is host-side control flow in this engine (irregular,
 * data-dependent early exits); this keeps it off the Python interpreter.
 *
 * Build: cc -O2 -shared -fPIC -o libchainx.so chainx.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NO_CON 0
#define REG_CON 1
#define SAME_CON 2
#define OVL_CON 3
#define TOP_N 1000

typedef struct {
    int64_t *cells;
    int64_t len;
    int64_t score;
} chain_t;

static inline int ilog2_64(uint64_t v) {
    if (v == 0) return -1;
    return 63 - __builtin_clzll(v);
}

static inline int get_con_score(
    int64_t cur_start, int64_t cur_end, int64_t pre_start, int64_t pre_end,
    int64_t k, int64_t *con_score)
{
    int64_t cur_p = cur_end - cur_start, pre_p = pre_end - pre_start;
    if (cur_start <= pre_start || (double)cur_p >= (double)pre_p * 1.8 ||
        (double)pre_p >= (double)cur_p * 1.8)
        return NO_CON;
    int64_t dis1 = cur_end - pre_end; if (dis1 < 0) dis1 = -dis1;
    int64_t dis2 = cur_start - pre_start; if (dis2 < 0) dis2 = -dis2;
    int64_t m1 = dis1 < k ? dis1 : k, m2 = dis2 < k ? dis2 : k;
    int64_t matched = m1 + m2;
    int64_t dp_ = cur_p - pre_p; if (dp_ < 0) dp_ = -dp_;
    int64_t gap = dp_ * dp_ / 2 + ilog2_64((uint64_t)(dis1 + dis2)) / 2;
    *con_score = matched - gap;
    if (dp_ == 0) return matched < 2 * k ? OVL_CON : SAME_CON;
    return REG_CON;
}

/* ------------------------------------------------------------------ *
 * Vectorized DP scan (AVX-512, runtime-detected).
 *
 * Semantics: identical to the scalar loop below, exploiting that with
 * one hit per end position (always true for w=1 seeding: at most one
 * self-hit is emitted per k-mer occurrence) every end-group is a
 * singleton, so the group scan is a backward scan over flat indices.
 * A 16-lane block computes connection class + score for 16 predecessors
 * at once; a lane-parallel descending prefix-max then identifies the
 * block's RECORD lanes (strict running-max improvements — the only
 * lanes that can update the DP cell or reset iter_n) and its stop
 * lanes, so the sequential state machine only visits those rare
 * events: both NO_CON and non-improving connectable runs collapse
 * into gap arithmetic on iter_n (records are prefix maxima of the
 * score sequence, so they are computable lane-parallel regardless of
 * where the sequential walk stops).  The
 * float-free ratio test 5*cur_p >= 9*pre_p is exactly equivalent to the
 * reference's (double)cur_p >= pre_p*1.8 for all periods < 2^26 (1.8 in
 * binary64 is 9/5 + 4.44e-17; the rounded product never crosses an
 * integer boundary in this range).
 * ------------------------------------------------------------------ */
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>

#define VNEG (-(1 << 30))

__attribute__((target("avx512f,avx512cd,avx512bw,avx512dq,avx512vl")))
static void run_dp_avx(
    const int32_t *ends, const int32_t *starts, int32_t *score,
    int32_t *from, int64_t n, int32_t k, int32_t *pmax)
{
    const __m512i v9 = _mm512_set1_epi32(9);
    const __m512i v5 = _mm512_set1_epi32(5);
    const __m512i v2k = _mm512_set1_epi32(2 * k);
    const __m512i vk = _mm512_set1_epi32(k);
    const __m512i vneg = _mm512_set1_epi32(VNEG);
    pmax[0] = score[0];
    for (int64_t cur = 1; cur < n; ++cur) {
        int32_t cs = starts[cur], ce = ends[cur];
        int32_t cp = ce - cs;
        int32_t max_score = score[cur];
        int64_t max_pre = -1;
        int32_t max_h = cp, iter_n = 0;
        const __m512i v_cs = _mm512_set1_epi32(cs);
        const __m512i v_ce = _mm512_set1_epi32(ce);
        const __m512i v_cp = _mm512_set1_epi32(cp);
        const __m512i v_9cp = _mm512_set1_epi32(9 * cp);
        const __m512i v_5cp = _mm512_set1_epi32(5 * cp);
        int done = 0;
        for (int64_t hi = cur - 1; hi >= 0 && !done; hi -= 16) {
            /* Upper-bound prune: every connection adds matched - gap
             * <= 2k to score[pre], so no candidate in 0..hi can STRICTLY
             * beat max_score once pmax[hi] + 2k <= max_score; stop lanes
             * only end the scan, so terminating here is result-identical
             * (pmax = running prefix max of finalized scores). */
            if (pmax[hi] + 2 * k <= max_score) break;
            int64_t lo = hi - 15 < 0 ? 0 : hi - 15;
            int nl = (int)(hi - lo + 1);
            __mmask16 ml = (__mmask16)(nl == 16 ? 0xFFFFu : ((1u << nl) - 1u));
            __m512i ew = _mm512_maskz_loadu_epi32(ml, ends + lo);
            __m512i sw = _mm512_maskz_loadu_epi32(ml, starts + lo);
            __mmask16 valid = _mm512_mask_cmpge_epi32_mask(ml, ew, v_cs);
            if (valid != ml) done = 1;
            if (!valid) break;
            int floor_lane = __builtin_ctz((unsigned)valid);
            __m512i pp = _mm512_sub_epi32(ew, sw);
            __mmask16 c1 = _mm512_cmple_epi32_mask(v_cs, sw);
            __m512i pp9 = _mm512_mullo_epi32(pp, v9);
            __m512i pp5 = _mm512_mullo_epi32(pp, v5);
            __mmask16 c2 = _mm512_cmpge_epi32_mask(v_5cp, pp9);
            __mmask16 c3 = _mm512_cmpge_epi32_mask(pp5, v_9cp);
            __mmask16 im = valid & (__mmask16)~(c1 | c2 | c3);
            if (!im) {
                /* all-NO_CON block: pure gap arithmetic */
                int nv = __builtin_popcount(valid);
                if (iter_n + nv >= max_h) { done = 1; break; }
                iter_n += nv;
                continue;
            }
            __m512i scv = _mm512_maskz_loadu_epi32(valid, score + lo);
            __m512i dis1 = _mm512_sub_epi32(v_ce, ew);
            __m512i dis2 = _mm512_sub_epi32(v_cs, sw);
            __m512i matched = _mm512_add_epi32(
                _mm512_min_epi32(dis1, vk), _mm512_min_epi32(dis2, vk));
            __m512i dlt = _mm512_abs_epi32(_mm512_sub_epi32(v_cp, pp));
            __m512i d2 = _mm512_srli_epi32(_mm512_mullo_epi32(dlt, dlt), 1);
            __m512i ds = _mm512_add_epi32(dis1, dis2);
            __m512i lg = _mm512_sub_epi32(_mm512_set1_epi32(31), _mm512_lzcnt_epi32(ds));
            __m512i gap = _mm512_add_epi32(d2, _mm512_srli_epi32(lg, 1));
            __m512i sc = _mm512_add_epi32(scv, _mm512_sub_epi32(matched, gap));
            __mmask16 same_ovl = _mm512_cmpeq_epi32_mask(dlt, _mm512_setzero_si512());
            __mmask16 ovl = same_ovl & _mm512_cmplt_epi32_mask(matched, v2k);
            /* records: descending-order (lane 15 -> 0) strict prefix maxima
             * of interesting sc, seeded with the running max */
            __m512i scm = _mm512_mask_mov_epi32(vneg, im, sc);
            __m512i t = _mm512_alignr_epi32(vneg, scm, 1);
            t = _mm512_max_epi32(t, _mm512_alignr_epi32(vneg, t, 1));
            t = _mm512_max_epi32(t, _mm512_alignr_epi32(vneg, t, 2));
            t = _mm512_max_epi32(t, _mm512_alignr_epi32(vneg, t, 4));
            t = _mm512_max_epi32(t, _mm512_alignr_epi32(vneg, t, 8));
            t = _mm512_max_epi32(t, _mm512_set1_epi32(max_score));
            __mmask16 rec = im & _mm512_cmpgt_epi32_mask(scm, t);
            __mmask16 sm = (__mmask16)((ovl & ~rec) | (same_ovl & rec));
            unsigned ev = (unsigned)(rec | sm);
            int32_t sc_a[16];
            _mm512_storeu_si512((__m512i *)sc_a, sc);
            int prev = nl;
            while (ev) {
                int lane = 31 - __builtin_clz(ev);
                int gaplen = prev - 1 - lane;
                if (iter_n + gaplen >= max_h) { done = 1; break; }
                iter_n += gaplen;
                if ((rec >> lane) & 1) {
                    max_score = sc_a[lane]; max_pre = lo + lane;
                    if ((sm >> lane) & 1) { done = 1; break; }
                    iter_n = 0;
                } else {            /* ovl non-record stop */
                    done = 1; break;
                }
                prev = lane;
                ev &= (1u << lane) - 1u;
            }
            if (!done) {
                int gaplen = prev - floor_lane;
                if (iter_n + gaplen >= max_h) done = 1;
                else iter_n += gaplen;
            }
        }
        if (max_pre >= 0) { score[cur] = max_score; from[cur] = (int32_t)max_pre; }
        pmax[cur] = pmax[cur - 1] > score[cur] ? pmax[cur - 1] : score[cur];
    }
}

static int avx512_ok(void)
{
    static int cached = -1;
    if (cached < 0)
        cached = __builtin_cpu_supports("avx512f")
              && __builtin_cpu_supports("avx512cd")
              && __builtin_cpu_supports("avx512bw")
              && __builtin_cpu_supports("avx512dq")
              && __builtin_cpu_supports("avx512vl");
    return cached;
}
#else
static int avx512_ok(void) { return 0; }
#endif

/* ranking entry */
typedef struct { int64_t flat, grp, j, score; } rank_t;

static int rank_cmp(const void *a, const void *b) {
    const rank_t *x = (const rank_t *)a, *y = (const rank_t *)b;
    if (x->score != y->score) return x->score > y->score ? -1 : 1;
    if (x->grp != y->grp) return x->grp > y->grp ? -1 : 1;   /* i desc */
    return x->j < y->j ? -1 : 1;                              /* j asc */
}

/* chain geometry helpers on the flat dp arrays */
static int is_overlap_chain1(
    const int64_t *start, const chain_t *c1, const chain_t *c2)
{
    int64_t s1 = start[c1->cells[0]], e1 = start[c1->cells[c1->len - 1]];
    int64_t s2 = start[c2->cells[0]], e2 = start[c2->cells[c2->len - 1]];
    int64_t mn = (e1 - s1) < (e2 - s2) ? (e1 - s1) : (e2 - s2);
    int64_t ov = ((e1 < e2) ? e1 : e2) - ((s1 > s2) ? s1 : s2);
    double ratio = (double)ov / (double)mn; /* mn==0 -> inf/nan like C */
    return ratio >= 0.5;
}

/* Post-DP processing (ranking, backtrack, overlap dedup, sort_chain,
 * post-filter) shared by th_chain and th_chain_post. */
static int64_t chain_post(
    const int64_t *ends, const int64_t *start, const int64_t *score,
    const int64_t *from, const int64_t *grp_of, const int64_t *gptr,
    int64_t n, int64_t tot_n,
    int64_t *out_cells, int64_t *out_offsets, int64_t *out_est);

/* returns the number of post-processed chains; caller buffers:
 *   out_cells   cap n      (flat cell indices, concatenated)
 *   out_offsets cap TOP_N+1
 *   out_est     cap TOP_N*3 (est_period, est_start, est_ch_i per chain)
 */
int64_t th_chain(
    const int64_t *ends, const int64_t *periods, int64_t n, int64_t k,
    int64_t *out_cells, int64_t *out_offsets, int64_t *out_est)
{
    if (n < 2) return 0;
    /* group by end (input sorted by end, then period) */
    int64_t *start = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *score = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *from = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *grp_of = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t tot_n = 0, i;
    for (i = 0; i < n; ++i) {
        if (i == 0 || ends[i] != ends[i - 1]) tot_n++;
        grp_of[i] = tot_n - 1;
        start[i] = ends[i] - periods[i];
        score[i] = k + (k < periods[i] ? k : periods[i]);
        from[i] = -1;
    }
    int64_t *gptr = (int64_t *)malloc((tot_n + 1) * sizeof(int64_t));
    {
        int64_t g = 0;
        for (i = 0; i < n; ++i)
            if (i == 0 || ends[i] != ends[i - 1]) gptr[g++] = i;
        gptr[tot_n] = n;
    }

    /* main DP (tandem_chain.c:321-356) — vectorized fast path when every
     * end-group is a singleton and values fit the 32-bit lane bounds
     * (periods < 2^15 keeps delta^2 in int32; see run_dp_avx header) */
    int use_avx = 0;
#if defined(__x86_64__) && defined(__GNUC__)
    if (tot_n == n && avx512_ok() && ends[n - 1] < (1 << 30)) {
        int64_t maxp = 0;
        for (i = 0; i < n; ++i)
            if (periods[i] > maxp) maxp = periods[i];
        if (maxp < (1 << 15)) {
            int32_t *e32 = (int32_t *)malloc(n * 4);
            int32_t *s32 = (int32_t *)malloc(n * 4);
            int32_t *sc32 = (int32_t *)malloc(n * 4);
            int32_t *fr32 = (int32_t *)malloc(n * 4);
            int32_t *pm32 = (int32_t *)malloc(n * 4);
            for (i = 0; i < n; ++i) {
                e32[i] = (int32_t)ends[i];
                s32[i] = (int32_t)start[i];
                sc32[i] = (int32_t)score[i];
                fr32[i] = -1;
            }
            run_dp_avx(e32, s32, sc32, fr32, n, (int32_t)k, pm32);
            for (i = 0; i < n; ++i) {
                score[i] = sc32[i];
                from[i] = fr32[i];
            }
            free(e32); free(s32); free(sc32); free(fr32); free(pm32);
            use_avx = 1;
        }
    }
#endif
    if (!use_avx) {
    /* running prefix max of finalized scores, for the same upper-bound
     * prune as the AVX path (connections add at most 2k) */
    int64_t *pmax = (int64_t *)malloc(n * sizeof(int64_t));
    pmax[0] = score[0];
    for (i = 1; i < gptr[1]; ++i)
        pmax[i] = pmax[i - 1] > score[i] ? pmax[i - 1] : score[i];
    for (int64_t gi = 1; gi < tot_n; ++gi) {
        for (int64_t cur = gptr[gi]; cur < gptr[gi + 1]; ++cur) {
            int64_t cs = start[cur], ce = ends[cur];
            int64_t max_score = score[cur], max_pre = -1;
            int64_t max_h = ce - cs, iter_n = 0;
            for (int64_t pi = gi - 1; pi >= 0; --pi) {
                if (ends[gptr[pi]] < cs) break;
                if (pmax[gptr[pi + 1] - 1] + 2 * k <= max_score) break;
                int gt = 0, stop = 0;
                for (int64_t pre = gptr[pi]; pre < gptr[pi + 1]; ++pre) {
                    int64_t cons;
                    int res = get_con_score(cs, ce, start[pre], ends[pre], k, &cons);
                    if (res == NO_CON) continue;
                    int64_t sc = score[pre] + cons;
                    if (sc > max_score) {
                        max_score = sc; max_pre = pre;
                        if (res == SAME_CON || res == OVL_CON) { stop = 1; break; }
                        gt = 1;
                    } else if (res == OVL_CON) { stop = 1; break; }
                }
                if (stop) break;
                if (gt) iter_n = 0;
                else if (++iter_n >= max_h) break;
            }
            if (max_score > score[cur]) { score[cur] = max_score; from[cur] = max_pre; }
        }
        for (int64_t f = gptr[gi]; f < gptr[gi + 1]; ++f)
            pmax[f] = pmax[f - 1] > score[f] ? pmax[f - 1] : score[f];
    }
    free(pmax);
    }

    int64_t n_post = chain_post(ends, start, score, from, grp_of, gptr,
                                n, tot_n, out_cells, out_offsets, out_est);
    free(start); free(score); free(from); free(grp_of); free(gptr);
    return n_post;
}

/* Entry for a DP computed elsewhere (the device chain kernel,
 * ops/chaining_jax.py): takes per-cell score/from arrays and runs only
 * the ranking/backtrack/dedup post-processing. */
int64_t th_chain_post(
    const int64_t *ends, const int64_t *periods,
    const int64_t *score, const int64_t *from, int64_t n,
    int64_t *out_cells, int64_t *out_offsets, int64_t *out_est)
{
    if (n < 2) return 0;
    int64_t *start = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *grp_of = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t tot_n = 0, i;
    for (i = 0; i < n; ++i) {
        if (i == 0 || ends[i] != ends[i - 1]) tot_n++;
        grp_of[i] = tot_n - 1;
        start[i] = ends[i] - periods[i];
    }
    int64_t *gptr = (int64_t *)malloc((tot_n + 1) * sizeof(int64_t));
    {
        int64_t g = 0;
        for (i = 0; i < n; ++i)
            if (i == 0 || ends[i] != ends[i - 1]) gptr[g++] = i;
        gptr[tot_n] = n;
    }
    int64_t n_post = chain_post(ends, start, score, from, grp_of, gptr,
                                n, tot_n, out_cells, out_offsets, out_est);
    free(start); free(grp_of); free(gptr);
    return n_post;
}

static int64_t chain_post(
    const int64_t *ends, const int64_t *start, const int64_t *score,
    const int64_t *from, const int64_t *grp_of, const int64_t *gptr,
    int64_t n, int64_t tot_n,
    int64_t *out_cells, int64_t *out_offsets, int64_t *out_est)
{
    int64_t i, j;
    uint8_t *tracked = (uint8_t *)calloc(n, 1);

    /* rank positive cells: (grp desc, j asc) stable under score desc.
     * Collection order IS the tie order, so a stable counting sort by
     * score replaces the comparison sort (scores are small ints: <= 2k
     * per chain link; qsort was ~40% of the whole post-processing). */
    rank_t *rank = (rank_t *)malloc(n * sizeof(rank_t));
    int64_t rn = 0;
    int64_t smax = 0;
    for (int64_t gi = tot_n - 1; gi >= 0; --gi)
        for (int64_t f = gptr[gi]; f < gptr[gi + 1]; ++f)
            if (score[f] > 0) {
                rank[rn].flat = f; rank[rn].grp = gi;
                rank[rn].j = f - gptr[gi]; rank[rn].score = score[f];
                if (score[f] > smax) smax = score[f];
                rn++;
            }
    if (rn > 64 && smax <= (1 << 18)) {
        int64_t *cnt = (int64_t *)calloc(smax + 2, sizeof(int64_t));
        rank_t *sorted = (rank_t *)malloc(rn * sizeof(rank_t));
        for (int64_t r = 0; r < rn; ++r)
            cnt[smax - rank[r].score]++;           /* descending key */
        int64_t acc = 0;
        for (int64_t s = 0; s <= smax; ++s) {
            int64_t c = cnt[s]; cnt[s] = acc; acc += c;
        }
        for (int64_t r = 0; r < rn; ++r)
            sorted[cnt[smax - rank[r].score]++] = rank[r];
        memcpy(rank, sorted, rn * sizeof(rank_t));
        free(sorted); free(cnt);
    } else {
        qsort(rank, rn, sizeof(rank_t), rank_cmp);
    }

    /* chain cell buffers allocate lazily: typical reads produce 1-3
     * chains, so eagerly mallocing TOP_N=1000 tot_n-sized buffers per
     * read dominated the whole DP's runtime */
    chain_t *chains = (chain_t *)calloc(TOP_N, sizeof(chain_t));
    int64_t *chain_idx = (int64_t *)malloc(TOP_N * sizeof(int64_t));
    for (i = 0; i < TOP_N; ++i)
        chain_idx[i] = i;
    int64_t ch_n = 0;

    for (int64_t ri = 0; ri < rn && ch_n < TOP_N; ++ri) {
        int64_t flat = rank[ri].flat;
        /* is_in_chain (tandem_chain.c:170-185) */
        {
            int64_t cell_start = start[gptr[grp_of[flat]]];
            int64_t cell_end = ends[flat];
            int in = 0;
            for (int64_t _i = 0; _i < ch_n; ++_i) {
                chain_t *c = &chains[chain_idx[_i]];
                if (c->len <= 0) continue;
                int64_t c_start = start[c->cells[0]];
                int64_t c_end = ends[c->cells[c->len - 1]];
                if (c_end < cell_start) { in = 0; break; }
                if (c_start > cell_end) continue;
                if (cell_end - c_start >= (c_end - c_start) / 2) { in = 1; break; }
            }
            if (in) continue;
        }
        /* backtrack_dp (tandem_chain.c:86-111) */
        if (!tracked[flat]) {
            chain_t *nc = &chains[ch_n];
            if (nc->cells == NULL)
                nc->cells = (int64_t *)malloc(
                    (tot_n > 0 ? tot_n : 1) * sizeof(int64_t));
            int64_t sc = score[flat], cur = flat, len = 0;
            for (;;) {
                tracked[cur] = 1;
                nc->cells[len++] = cur;
                int64_t pre = from[cur];
                if (pre == -1) break;
                if (tracked[pre]) { sc -= score[pre]; break; }
                cur = pre;
            }
            /* reverse */
            for (i = 0, j = len - 1; i < j; ++i, --j) {
                int64_t t = nc->cells[i]; nc->cells[i] = nc->cells[j]; nc->cells[j] = t;
            }
            nc->len = len; nc->score = sc;
            int accept = 0;
            if (len > 1) {
                /* is_overlap_chain (tandem_chain.c:68-83) */
                int reject = 0;
                int64_t st = start[nc->cells[len - 1]];
                for (i = ch_n - 1; i >= 0; --i) {
                    chain_t *c = &chains[i];
                    if (c->len <= 0) continue;
                    if (ends[c->cells[c->len - 1]] <= st) break;
                    if (is_overlap_chain1(start, c, nc)) {
                        if (c->score > nc->score) reject = 1;
                        else c->len = 0;
                        break;
                    }
                }
                accept = !reject;
            }
            if (accept) ch_n++;
        }
        /* sort_chain — literal port incl. the index quirk
         * (tandem_chain.c:188-207) */
        if (ch_n >= 2) {
            for (int64_t _i = 0; _i < ch_n - 1; ++_i) {
                int64_t ii = chain_idx[_i];
                if (chains[ii].len <= 0) continue;
                int64_t e1 = ends[chains[ii].cells[chains[ii].len - 1]];
                for (int64_t _j = _i + 1; _j < ch_n; ++_j) {
                    int64_t jj = chain_idx[_j];
                    if (chains[jj].len <= 0) continue;
                    int64_t e2 = ends[chains[jj].cells[chains[jj].len - 1]];
                    if (e1 < e2) {
                        chain_idx[_i] = jj; chain_idx[_j] = ii;
                        e1 = e2;
                    }
                }
            }
        }
    }

    /* post-process (tandem_chain.c:391-400) */
    int64_t n_post = 0, cell_off = 0;
    out_offsets[0] = 0;
    for (i = ch_n - 1; i >= 0; --i) {
        chain_t *c = &chains[chain_idx[i]];
        if (c->len - 1 < 2) continue;
        memcpy(out_cells + cell_off, c->cells, c->len * sizeof(int64_t));
        cell_off += c->len;
        int64_t first = c->cells[0];
        out_est[n_post * 3 + 0] = ends[first] - start[first];
        out_est[n_post * 3 + 1] = start[first];
        out_est[n_post * 3 + 2] = 0;
        n_post++;
        out_offsets[n_post] = cell_off;
    }

    for (i = 0; i < TOP_N; ++i)
        if (chains[i].cells) free(chains[i].cells);
    free(chains); free(chain_idx); free(rank); free(tracked);
    return n_post;
}
