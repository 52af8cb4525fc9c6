/* Harness over the reference's own seeding/chaining/partition/consensus code.
 *
 * Modes:
 *   ./dump in.fa [k w hpc min_p max_p max_div]
 *       Golden dump: per read, hit count + per chain (n_cells, est_period,
 *       est_start, partition positions).  Used to pin bit-exact targets for
 *       the rebuild's tests.
 *
 *   ./dump -t in.fa [reps] [n_thread]
 *       Timing: run tidehunter_core over all reads (per-read pipeline through
 *       consensus with the stub abPOA — see abpoa.h) `reps` times; print a
 *       JSON line with per-stage seconds and reads/s.  n_thread is recorded
 *       in the JSON but the loop is single-threaded (1-core host VM); scale
 *       linearly for the t=32 extrapolation, as the reference's threading is
 *       embarrassingly parallel over reads (main.c:273-291).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>
#include <math.h>
#include <zlib.h>
#include "tidehunter.h"
#include "tandem_hit.h"
#include "tandem_chain.h"
#include "partition.h"
#include "gen_cons.h"
#include "abpoa_cons.h"
#include "seq.h"

/* local copy of mini_tandem_init_para (lives in main.c, which has its own
 * main() and so cannot be linked here); values from tidehunter.h + main.c:329 */
static mini_tandem_para *harness_init_para(void) {
    mini_tandem_para *mtp = (mini_tandem_para *)calloc(1, sizeof(mini_tandem_para));
    mtp->n_thread = THREAD_N;
    mtp->ada_match_rat = ADA_MATCH_RAT;
    mtp->k = KMER_SIZE; mtp->w = KMER_WSIZE; mtp->hpc = 0;
    mtp->min_copy = MIN_COPY;
    mtp->max_div = MAX_DIV;
    mtp->div_exp = exp(2 * KMER_SIZE * MAX_DIV);
    mtp->min_p = DEF_MIN_PERIOD; mtp->max_p = DEF_MAX_PERIOD;
    mtp->min_cov = 0; mtp->min_frac = 0.0;
    mtp->match = MATCH; mtp->mismatch = MISMATCH;
    mtp->gap_open1 = GAP_OPEN1; mtp->gap_open2 = GAP_OPEN2;
    mtp->gap_ext1 = GAP_EXT1; mtp->gap_ext2 = GAP_EXT2;
    mtp->cons_out = stdout;
    mtp->min_len = DEF_MIN_LEN;
    mtp->out_fmt = FASTA_FMT;
    mtp->max_range = REP_RANGE;
    return mtp;
}

static double now_sec(void) {
    struct timeval tv;
    gettimeofday(&tv, NULL);
    return tv.tv_sec + 1e-6 * tv.tv_usec;
}

tandem_seq_t *alloc_tandem_seq1(void) {
    tandem_seq_t *tseq = (tandem_seq_t *)malloc(sizeof(tandem_seq_t));
    tseq->cons_seq = (seq_t *)calloc(1, sizeof(seq_t));
    tseq->cons_n = 0; tseq->cons_m = 1;
    tseq->cons_start = (int *)malloc(sizeof(int));
    tseq->cons_end = (int *)malloc(sizeof(int));
    tseq->copy_num = (double *)malloc(sizeof(double));
    tseq->ave_match = (double *)malloc(sizeof(double));
    tseq->cons_len = (int *)malloc(sizeof(int));
    tseq->full_length = (int8_t *)malloc(sizeof(int8_t));
    tseq->cons_score = (int *)malloc(sizeof(int));
    tseq->pos_n = (int *)calloc(1, sizeof(int));
    tseq->pos_m = (int *)calloc(1, sizeof(int));
    tseq->sub_pos = (int **)calloc(1, sizeof(int *));
    return tseq;
}

static void reset_tseq(tandem_seq_t *tseq) {
    tseq->cons_n = 0;
    tseq->cons_seq->seq.l = 0;
    tseq->cons_seq->qual.l = 0;
    int i;
    for (i = 0; i < tseq->cons_m; ++i) tseq->pos_n[i] = 0;
}

static int dump_mode(int argc, char *argv[]) {
    mini_tandem_para *mtp = harness_init_para();
    if (argc > 2) mtp->k = atoi(argv[2]);
    if (argc > 3) mtp->w = atoi(argv[3]);
    if (argc > 4) mtp->hpc = atoi(argv[4]);
    if (argc > 5) mtp->min_p = atoll(argv[5]);
    if (argc > 6) mtp->max_p = atoll(argv[6]);
    if (argc > 7) mtp->max_div = atof(argv[7]);

    gzFile fp = gzopen(argv[1], "r");
    if (!fp) { fprintf(stderr, "open fail %s\n", argv[1]); return 1; }
    kseq_t *ks = kseq_init(fp);
    while (kseq_read(ks) >= 0) {
        int seq_len = ks->seq.l;
        uint8_t *bseq = get_bseq(ks->seq.s, seq_len);
        hash_t *hit_h; int hit_n = collect_tandem_repeat_hit(bseq, seq_len, mtp, &hit_h);
        printf("read\t%s\t%d\thits\t%d\n", ks->name.s, seq_len, hit_n);
        dp_t **dp; int tot_n = 0; chain_t *chain; int ch_m = 0;
        int ch_n = tandem_chain(seq_len, hit_h, hit_n, mtp, &dp, &tot_n, &chain, &ch_m);
        int ch_i, i;
        for (ch_i = 0; ch_i < ch_n; ++ch_i) {
            chain_t ch = chain[ch_i];
            int par_n, *par_pos;
            par_pos = get_partition_pos_with_narrow_global_alignment(bseq, seq_len, dp, ch, mtp, &par_n);
            printf("chain\t%d\tcells\t%d\tperiod\t%d\tstart\t%d\tpar", ch_i, ch.len, ch.est_period, ch.est_start);
            for (i = 0; i < par_n; ++i) printf("\t%d", par_pos[i]);
            printf("\n");
            free(par_pos);
        }
        if (hit_n > 0) free(hit_h);
        if (ch_m > 0) { for (i = 0; i < ch_m; ++i) free(chain[i].cell); free(chain); }
        if (tot_n > 0) { for (i = 0; i <= tot_n; ++i) free(dp[i]); free(dp); }
        free(bseq);
    }
    kseq_destroy(ks); gzclose(fp);
    free(mtp);
    return 0;
}

static int timing_mode(int argc, char *argv[]) {
    const char *fn = argv[2];
    int reps = argc > 3 ? atoi(argv[3]) : 1;
    int n_thread = argc > 4 ? atoi(argv[4]) : 1;

    mini_tandem_para *mtp = harness_init_para();
    mtp->cons_out = fopen("/dev/null", "w");

    /* load all reads into memory first so IO is excluded */
    gzFile fp = gzopen(fn, "r");
    if (!fp) { fprintf(stderr, "open fail %s\n", fn); return 1; }
    kseq_t *ks = kseq_init(fp);
    int n_reads = 0, m_reads = 1024;
    kseq_t *reads = (kseq_t *)calloc(m_reads, sizeof(kseq_t));
    long total_bases = 0;
    while (kseq_read(ks) >= 0) {
        if (n_reads == m_reads) {
            m_reads <<= 1;
            reads = (kseq_t *)realloc(reads, m_reads * sizeof(kseq_t));
            memset(reads + n_reads, 0, (m_reads - n_reads) * sizeof(kseq_t));
        }
        kseq_t *r = &reads[n_reads++];
        r->seq.l = ks->seq.l; r->seq.s = strdup(ks->seq.s);
        r->name.l = ks->name.l; r->name.s = strdup(ks->name.s);
        total_bases += ks->seq.l;
    }
    kseq_destroy(ks); gzclose(fp);

    abpoa_para_t *abpt = mt_abpoa_init_para(mtp);
    abpoa_t *ab = abpoa_init();
    tandem_seq_t *tseq = alloc_tandem_seq1();

    /* stage timing pass: seed / chain / partition separately (one rep) */
    double t_seed = 0, t_chain = 0, t_par = 0, t0;
    for (int i = 0; i < n_reads; ++i) {
        kseq_t *r = &reads[i];
        int seq_len = r->seq.l;
        uint8_t *bseq = get_bseq(r->seq.s, seq_len);
        t0 = now_sec();
        hash_t *hit_h; int hit_n = collect_tandem_repeat_hit(bseq, seq_len, mtp, &hit_h);
        t_seed += now_sec() - t0;
        t0 = now_sec();
        dp_t **dp; int tot_n = 0; chain_t *chain; int ch_m = 0;
        int ch_n = tandem_chain(seq_len, hit_h, hit_n, mtp, &dp, &tot_n, &chain, &ch_m);
        t_chain += now_sec() - t0;
        t0 = now_sec();
        for (int ch_i = 0; ch_i < ch_n; ++ch_i) {
            int par_n, *par_pos;
            par_pos = get_partition_pos_with_narrow_global_alignment(bseq, seq_len, dp, chain[ch_i], mtp, &par_n);
            free(par_pos);
        }
        t_par += now_sec() - t0;
        if (hit_n > 0) free(hit_h);
        if (ch_m > 0) { for (int j = 0; j < ch_m; ++j) free(chain[j].cell); free(chain); }
        if (tot_n > 0) { for (int j = 0; j <= tot_n; ++j) free(dp[j]); free(dp); }
        free(bseq);
    }

    /* end-to-end pass: full tidehunter_core (stub POA), reps times */
    double t_full0 = now_sec();
    for (int rep = 0; rep < reps; ++rep) {
        for (int i = 0; i < n_reads; ++i) {
            reset_tseq(tseq);
            tidehunter_core(&reads[i], tseq, mtp, ab, abpt);
        }
    }
    double t_full = (now_sec() - t_full0) / reps;

    printf("{\"reads\": %d, \"bases\": %ld, \"reps\": %d, "
           "\"seed_s\": %.4f, \"chain_s\": %.4f, \"partition_s\": %.4f, "
           "\"full_core_s\": %.4f, \"reads_per_s_1t\": %.3f, "
           "\"reads_per_s_%dt_linear\": %.3f, "
           "\"note\": \"full_core excludes only the abPOA graph-DP (stubbed); upper bound on reference speed\"}\n",
           n_reads, total_bases, reps, t_seed, t_chain, t_par, t_full,
           n_reads / t_full, n_thread, n_thread * n_reads / t_full);
    return 0;
}

int main(int argc, char *argv[]) {
    if (argc < 2) { fprintf(stderr, "usage: dump [-t] in.fa ...\n"); return 1; }
    if (strcmp(argv[1], "-t") == 0) return timing_mode(argc, argv);
    return dump_mode(argc, argv);
}
