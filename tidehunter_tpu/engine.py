"""Batched device engine: the accelerator execution path of the pipeline.

The per-read pipeline stages are generators that yield alignment requests
(ops/partition.partition_walk, pipeline/consensus.seqs_msa_gen); this engine
drives many reads' generators concurrently and resolves each round of
requests with batched device calls, bucketed by length:

  chunk of reads
    -> encode + seed (vectorized NumPy)                      [host]
    -> chain DP (native C, exact)                            [host]
    -> partition walks, breadth-first across reads           [host C / device]
    -> consensus: profile-POA MSA + aveMatch + boundary ext  [device batches]
    -> full-length adapters (Myers), record assembly         [device / host]

Chain/region record order within a read is kept reference-identical by
running each read's consensus generators strictly in sequence (chains are
sequential per read; different reads interleave freely).

Request kinds:
  ('global', q, t, qle) -> (iden_n, t_left_ext)     ksw2 scoring
  ('giden', q, t)       -> iden_n                   ksw2 scoring
  ('gidens', [(q, t)])  -> [iden_n]                 batched variant
  ('ext', q, t)         -> (max_q, max_t)           ksw2 scoring
  ('exts', [(q, t)])    -> [(max_q, max_t)]         batched variant
  ('msa', units)        -> (cons, cov)              profile-POA

Stage implementations, chosen once per engine from its platform:
  gpu  alignment: Pallas-Triton wavefront kernels (ops/wavefront.py)
       MSA:       device profile-POA (ops/msa_device.py)
  cpu  alignment: plain-XLA wavefront (ops/ksw2_jax.py)
       MSA:       host oracle (pipeline/consensus.resolve_oracle)
interpret=True runs the gpu kernels through the Pallas interpreter (tests
on a machine without a card).  Two host paths remain by design, each
counted in METRICS: alignments past the largest bucket ('host_cap_aln')
and MSA regions past the largest MSA bucket ('host_cap_msa').
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .io.codec import encode
from .io.output import TandemResult
from .params import Params
from .ops import ksw2
from .ops.chaining_native import tandem_chain_from_dp, tandem_chain_native
from .ops.partition import (
    combine_walks,
    partition_walk_left,
    partition_walk_right,
)
from .ops.seeding_native import collect_tandem_repeat_hits
from .pipeline.consensus import (
    resolve_oracle,
    seqs_msa_gen,
    single_copy_full_len_gen,
)
from .utils.log import log
from .utils.metrics import METRICS

KSW2_SCORES = (ksw2.MATCH_SC, ksw2.MIS_SC, ksw2.GAP_OPEN, ksw2.GAP_EXT)
PLATFORMS = ("gpu", "cpu")


def check_backend(platform: str, interpret: bool = False) -> None:
    """platform 'gpu' needs JAX's GPU backend (or the interpreter); the
    CPU is never a silent stand-in for the card."""
    import jax

    if platform not in PLATFORMS:
        raise ValueError(f"device platform must be one of {PLATFORMS}, "
                         f"got {platform!r}")
    if platform == "gpu" and not interpret:
        backend = jax.default_backend()
        if backend != "gpu":
            raise RuntimeError(
                f"--device gpu needs a GPU, but JAX's backend is "
                f"{backend!r} (use --device cpu or --device off)")


def _rows(n: int, cap: int, mesh_n: int) -> int:
    """Shape-stable batch rows for n requests: per-shard rungs 8, 32,
    128, ... up to cap (each distinct shape compiles once), times the
    mesh size so every shard holds whole rows."""
    per = -(-max(1, n) // mesh_n)
    b = 8
    while b < per and b < cap:
        b *= 4
    return min(b, cap) * mesh_n


class BatchAligner:
    """Pads, buckets and dispatches alignment requests to the device.

    kernels=True: the Pallas-Triton wavefront kernels (one program per
    problem, so padding rows cost one anti-diagonal); their lane counts
    are powers of two, so the length buckets are too.  kernels=False: the
    plain-XLA wavefront of ops/ksw2_jax.py over the Params ladder."""

    def __init__(self, buckets: Sequence[int], kernels: bool,
                 interpret: bool = False):
        self.kernels = kernels
        self.interpret = interpret
        if kernels:
            from .ops import wavefront

            self.wf = wavefront
            buckets = {wavefront.lanes(b) for b in buckets}
        else:
            from .ops import ksw2_jax

            self.kmod = ksw2_jax
        self.buckets = sorted(buckets)
        # requests at or below this size (both sides) resolve host-side in
        # native C; 0 disables. Default covers the partition walk's window
        # distribution while keeping unit-scale work (aveMatch, ext) on
        # the device.
        # clamp: the native single-request pack is (iden << 20)|(tleft+1),
        # so the target side must stay below 2^20 or the fields collide
        self.host_aln_cap = min(
            int(os.environ.get("TH_HOST_ALN_CAP", "192")), (1 << 20) - 2
        )

    def _bucket(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _grouped(self, reqs, qi=0, ti=1):
        """Rectangular buckets: LQ and LT bucket independently, so the
        boundary-extension batches (q = consensus, t clamped to 2q) do
        not pad to LT^2; only (LQ, LT) combos that occur compile.
        Requests past the largest bucket go to the counted host cap."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        host: List[int] = []
        for i, req in enumerate(reqs):
            bq = self._bucket(max(1, len(req[qi])))
            bt = self._bucket(max(1, len(req[ti])))
            if bq is None or bt is None:
                host.append(i)
            else:
                groups.setdefault((bq, bt), []).append(i)
        if host:
            METRICS.add("host_cap_aln", len(host))
        return groups, host

    def _row_cap(self, LQ: int, LT: int) -> int:
        if self.kernels:
            # one program per problem: 2048 programs are ~15 per SM of
            # the H100's 132, and their shift scratch (2 x 4 planes x
            # TL+1 int32) stays under 540 MB even at TL = 8192; the
            # interpreter runs programs one by one, so keep it small
            return 8 if self.interpret else 2048
        # the plain path keeps B x (LQ+LT) x LT direction bytes on device
        cap = (1 << 28) // ((LQ + LT) * LT)
        return max(8, 1 << (max(1, cap).bit_length() - 1))

    @staticmethod
    def _pad(reqs, idxs, LQ, LT, B, qi=0, ti=1):
        METRICS.add("device_items", len(idxs))
        METRICS.add("device_rows", B)
        METRICS.add("kernel_calls")
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        qlen = np.ones(B, np.int32)
        tlen = np.ones(B, np.int32)
        # per-row block copies — each row is one memcpy
        for row, i in enumerate(idxs):
            qs, ts = reqs[i][qi], reqs[i][ti]
            q[row, : len(qs)] = qs
            t[row, : len(ts)] = ts
            qlen[row] = max(1, len(qs))
            tlen[row] = max(1, len(ts))
        # useful DP cells (sum qlen*tlen) vs dispatched capacity (B*LQ*LT)
        METRICS.add("wf_cells", float(
            np.dot(qlen.astype(np.float64), tlen.astype(np.float64))))
        METRICS.add("wf_cells_disp", float(B) * LQ * LT)
        return q, qlen, t, tlen

    def _dispatch(self, reqs, groups, out, call):
        """One device call per (bucket, rows) piece; every piece's [B, 2]
        result is concatenated on device and pulled in one transfer."""
        import jax.numpy as jnp

        from .parallel.mesh import active_mesh_n

        mesh_n = active_mesh_n() if self.kernels else 1
        chunks = []
        placed: List[Tuple[List[int], int]] = []
        off = 0
        for (LQ, LT), idxs in groups.items():
            cap = self._row_cap(LQ, LT)
            i = 0
            while i < len(idxs):
                B = _rows(len(idxs) - i, cap, mesh_n)
                pidx = idxs[i:i + B]
                i += B
                q, qlen, t, tlen = self._pad(reqs, pidx, LQ, LT, B)
                chunks.append(call(pidx, q, qlen, t, tlen))
                placed.append((pidx, off))
                off += B
        if not chunks:
            return
        res = np.asarray(chunks[0] if len(chunks) == 1
                         else jnp.concatenate(chunks, axis=0))
        for idxs, base in placed:
            for row, i in enumerate(idxs):
                out[i] = (int(res[base + row, 0]), int(res[base + row, 1]))

    def run_global(self, reqs, scores=KSW2_SCORES, need_tleft=True):
        """reqs: [(q, t, qle)] -> [(iden_n, t_left_ext)].

        Small requests (<= host_aln_cap a side) resolve host-side in
        native C (ops/ksw2_native.py, oracle-bit-exact): the partition
        walk's alignments are tiny (~34 bp mean) and sequential per
        chain, so a device round per walk step would buy a ~2 us DP.
        The remainder takes one device call per length bucket.

        need_tleft=False (run_giden) dispatches the leaner iden-only
        kernel variant."""
        out: List = [None] * len(reqs)
        if scores == KSW2_SCORES:
            from .ops.ksw2_native import available, global_tleft_batch

            if available():
                cap = self.host_aln_cap
                small = [
                    i for i, r in enumerate(reqs)
                    if max(len(r[0]), len(r[1])) <= cap
                ]
                if small:
                    METRICS.add("host_aln", len(small))
                    with METRICS.timed("host_aln"):
                        res = global_tleft_batch(
                            [reqs[i] for i in small])
                    for i, r in zip(small, res):
                        out[i] = r
                    if len(small) == len(reqs):
                        return out
                    keep = [i for i in range(len(reqs)) if out[i] is None]
                    sub = self.run_global(
                        [reqs[i] for i in keep], scores, need_tleft)
                    for i, r in zip(keep, sub):
                        out[i] = r
                    return out
        groups, host = self._grouped(reqs)
        if host:
            # over-bucket requests: one batched native call (the NumPy
            # oracle when the native library is absent)
            from .ops.ksw2_native import global_tleft_batch

            for i, r in zip(host, global_tleft_batch([reqs[i] for i in host])):
                out[i] = r

        def call(pidx, q, qlen, t, tlen):
            import jax.numpy as jnp

            qle = np.zeros(len(q), np.int32)
            for row, i in enumerate(pidx):
                qle[row] = max(0, reqs[i][2])
            if self.kernels:
                iden, tleft = self.wf.global_batch(
                    q, qlen, t, tlen, qle, scores,
                    iden_only=not need_tleft, interpret=self.interpret)
            else:
                _, iden, tleft = self.kmod.extz_global_batch(
                    q, qlen, t, tlen, qle, scores)
            return jnp.stack([iden, tleft], axis=1)

        with METRICS.timed("dev_global"):
            self._dispatch(reqs, groups, out, call)
        return out

    def run_giden(self, reqs, scores=KSW2_SCORES):
        """reqs: [(q, t)] -> [iden_n]"""
        res = self.run_global(
            [(q, t, 0) for q, t in reqs], scores, need_tleft=False)
        return [r[0] for r in res]

    def run_ext(self, reqs, scores=KSW2_SCORES):
        """reqs: [(q, t)] -> [(max_q, max_t)] (reverse beforehand for left).

        Targets are clamped to 2*len(q): an extension cell (t, q) scores
        H <= min(q,t)+1 - (GO + GE*(t-q)) <= 2q - t - 1, so any cell with
        H > 0 (the only ones the reference's max tracking can select,
        ksw2_extz2_sse.c:224-260) has t < 2*len(q). Without the clamp a
        short consensus vs a whole read flank lands in the largest length
        bucket and pays its full T^2."""
        reqs = [
            (q, t[: 2 * max(1, len(q))]) if len(t) > 2 * len(q) else (q, t)
            for q, t in reqs
        ]
        out: List = [None] * len(reqs)
        groups, host = self._grouped(reqs)
        for i in host:
            r = ksw2.extz(reqs[i][0], reqs[i][1], score_only=True)
            out[i] = (r.max_q, r.max_t)

        def call(pidx, q, qlen, t, tlen):
            import jax.numpy as jnp

            if self.kernels:
                _mx, mt, mq, _sc = self.wf.ext_batch(
                    q, qlen, t, tlen, scores, interpret=self.interpret)
            else:
                _mx, mt, mq, _sc = self.kmod.extz_score_batch(
                    q, qlen, t, tlen, scores)
            return jnp.stack([mq, mt], axis=1)

        with METRICS.timed("dev_ext"):
            self._dispatch(reqs, groups, out, call)
        return out


_LIVE_ENGINES: "weakref.WeakSet" = None  # type: ignore[assignment]


def _register_engine(engine: "Engine") -> None:
    """One module-level atexit hook over weakrefs: engines stay
    garbage-collectable (close() shuts their thread pool down) while
    stragglers still get their pools reaped at interpreter exit."""
    global _LIVE_ENGINES
    import weakref

    if _LIVE_ENGINES is None:
        _LIVE_ENGINES = weakref.WeakSet()
        import atexit

        def _close_all() -> None:
            for eng in list(_LIVE_ENGINES):
                eng.close()

        atexit.register(_close_all)
    _LIVE_ENGINES.add(engine)


def _drive(gens: List, resolver) -> None:
    """Breadth-first generator driving: collect one request per active
    generator, resolve them as one batch, resume."""
    pending: Dict[int, object] = {}
    results: Dict[int, object] = {}
    for gi, gen in enumerate(gens):
        try:
            pending[gi] = gen.send(None)
        except StopIteration:
            pass
    while pending:
        keys = list(pending.keys())
        reqs = [pending[kk] for kk in keys]
        answers = resolver(reqs)
        pending = {}
        for kk, ans in zip(keys, answers):
            try:
                pending[kk] = gens[kk].send(ans)
            except StopIteration:
                pass


class Engine:
    def __init__(self, mtp: Params, platform: str = "gpu",
                 msa_mode: str = "profile", mesh=None,
                 interpret: bool = False):
        """platform: 'gpu' (the Pallas-Triton kernels; the backend must be
        a GPU unless interpret=True runs them through the interpreter) or
        'cpu' (plain-XLA alignment, host MSA).  This is the one place the
        stage implementations are chosen.

        msa_mode: 'profile' = batched device profile-POA (bit-exact with
        ops/poa_profile.py, matches or beats graph-POA accuracy),
        'poa' = host oracles.

        mesh: optional 1-D jax.sharding.Mesh ('dp'); when set, the
        production wavefront and device-MSA batches shard over it (the
        pthread fan-out role of reference src/main.c:273-291 per SURVEY
        §5.8) — batch shapes scale with the mesh so per-card work is
        constant."""
        check_backend(platform, interpret)
        self.mtp = mtp
        self.msa_mode = msa_mode
        self.mesh = mesh
        self.kernels = platform == "gpu"
        self.interpret = interpret
        from .parallel.mesh import set_active_mesh

        set_active_mesh(mesh)
        self.aligner = BatchAligner(mtp.aln_bucket_sizes, self.kernels,
                                    interpret)
        self._pool = None
        self._pool_n = 0
        self._gx_pool = None
        _register_engine(self)

    # --- request resolution ---

    def _resolve_batch(self, reqs):
        by_kind: Dict[str, List[int]] = {}
        for i, req in enumerate(reqs):
            by_kind.setdefault(req[0], []).append(i)
        METRICS.add("rounds")
        for kind in by_kind:
            METRICS.add(f"rounds_{kind}")
        out: List = [None] * len(reqs)
        # Per-kind resolvers run CONCURRENTLY on the device path (each
        # fills disjoint out[] slots): a drive round mixing e.g. msa + gx
        # + hws generators would otherwise wait for one device round per
        # kind in turn.  Device waits release the GIL, so a small thread
        # pool overlaps every kind's dispatch+pull.
        tasks: List = []

        def _task(fn):
            tasks.append(fn)

        if "global" in by_kind:
            idxs = by_kind["global"]

            @_task
            def _do_global(idxs=idxs):
                res = self.aligner.run_global([reqs[i][1:] for i in idxs])
                for i, r in zip(idxs, res):
                    out[i] = r
        if "giden" in by_kind:
            idxs = by_kind["giden"]

            @_task
            def _do_giden(idxs=idxs):
                res = self.aligner.run_giden(
                    [(reqs[i][1], reqs[i][2]) for i in idxs])
                for i, r in zip(idxs, res):
                    out[i] = r
        if "gidens" in by_kind:
            # batched variant: one request carries a list of (q, t) pairs;
            # flatten across requests into one device round
            idxs = by_kind["gidens"]
            flat = []
            spans = []
            for i in idxs:
                pairs = reqs[i][1]
                spans.append((len(flat), len(pairs)))
                flat.extend(pairs)

            @_task
            def _do_gidens(idxs=idxs, flat=flat, spans=spans):
                res = self.aligner.run_giden(flat)
                for i, (lo, n) in zip(idxs, spans):
                    out[i] = res[lo : lo + n]
        if "ext" in by_kind:
            idxs = by_kind["ext"]

            @_task
            def _do_ext(idxs=idxs):
                res = self.aligner.run_ext(
                    [(reqs[i][1], reqs[i][2]) for i in idxs])
                for i, r in zip(idxs, res):
                    out[i] = r
        if "gx" in by_kind:
            # fused aveMatch identities + boundary extensions: both
            # batches dispatch in the same round (the generator would
            # otherwise pay two sequential round trips)
            idxs = by_kind["gx"]
            gflat, gspans, eflat, espans = [], [], [], []
            for i in idxs:
                gpairs, epairs = reqs[i][1], reqs[i][2]
                gspans.append((len(gflat), len(gpairs)))
                gflat.extend(gpairs)
                espans.append((len(eflat), len(epairs)))
                eflat.extend(epairs)

            # the two halves land as separate tasks so they overlap both
            # each other and every other kind in the round
            gres: List = []
            eres: List = []

            @_task
            def _do_gx_g(gres=gres, gflat=gflat):
                gres.extend(self.aligner.run_giden(gflat))

            @_task
            def _do_gx_e(eres=eres, eflat=eflat):
                eres.extend(self.aligner.run_ext(eflat))

            @_task
            def _do_gx_join(idxs=idxs, gspans=gspans, espans=espans,
                            gres=gres, eres=eres):
                # runs after the pool joins (ordered task list, see below)
                for i, (glo, gn), (elo, en) in zip(idxs, gspans, espans):
                    out[i] = (gres[glo:glo + gn], eres[elo:elo + en])
        if "exts" in by_kind:
            idxs = by_kind["exts"]
            flat = []
            spans = []
            for i in idxs:
                pairs = reqs[i][1]
                spans.append((len(flat), len(pairs)))
                flat.extend(pairs)

            @_task
            def _do_exts(idxs=idxs, flat=flat, spans=spans):
                res = self.aligner.run_ext(flat)
                for i, (lo, n) in zip(idxs, spans):
                    out[i] = res[lo : lo + n]
        if "hws" in by_kind:
            # batched Myers HW adapter searches (ops/myers_jax.py): all
            # requests' searches flatten into two device scans
            from .ops.myers_jax import hw_batch

            idxs = by_kind["hws"]
            flat_q, flat_t, flat_k, spans = [], [], [], []
            for i in idxs:
                trips = reqs[i][1]
                spans.append((len(flat_q), len(trips)))
                for q, t, k in trips:
                    flat_q.append(q)
                    flat_t.append(t)
                    flat_k.append(k)

            @_task
            def _do_hws(idxs=idxs, spans=spans):
                res = hw_batch(flat_q, flat_t, flat_k) if flat_q else []
                for i, (lo, n) in zip(idxs, spans):
                    out[i] = res[lo:lo + n]
        if "msa" in by_kind:
            idxs = by_kind["msa"]

            @_task
            def _do_msa(idxs=idxs):
                res = self._resolve_msa([reqs[i][1] for i in idxs])
                for i, r in zip(idxs, res):
                    out[i] = r

        # gx's join task must run after its two halves; it is ordered
        # last among gx tasks, and the serial path runs tasks in order
        # while the pooled path joins ALL compute tasks before the joins
        joins = [t for t in tasks if t.__name__ == "_do_gx_join"]
        work = [t for t in tasks if t.__name__ != "_do_gx_join"]
        if (len(work) > 1 and self.kernels
                and os.environ.get("TH_SERIAL_KINDS", "") != "1"):
            if self._gx_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._gx_pool = ThreadPoolExecutor(max_workers=6)
            futs = [self._gx_pool.submit(t) for t in work]
            for f in futs:
                f.result()
        else:
            for t in work:
                t()
        for t in joins:
            t()
        return out

    def _resolve_msa(self, regions: List[List[np.ndarray]]):
        if self.msa_mode == "profile" and self.kernels:
            return self._resolve_msa_device(regions)
        # the cpu engine and --msa graph take the bit-exact host oracle
        METRICS.add("msa_host", len(regions))
        return [
            resolve_oracle(("msa", units), self.mtp)
            for units in regions
        ]

    def _resolve_msa_device(self, regions: List[List[np.ndarray]]):
        """Device-resident profile-POA (ops/msa_device.py): all unit rounds
        run on the device with no intermediate host pulls; regions past
        the largest MSA bucket take the full-width host pass, counted as
        'host_cap_msa'. Bit-exact with the host mirror
        ops/poa_profile.banded_profile_consensus."""
        if not hasattr(self, "_device_msa"):
            from .ops import msa_device

            m = self.mtp
            self._device_msa = msa_device.shared(
                m.match, m.mismatch, m.gap_open1, m.gap_ext1,
                polish=getattr(m, "polish", 0), mesh=self.mesh,
                gap_open2=m.gap_open2, gap_ext2=m.gap_ext2,
                interpret=self.interpret,
            )
        with METRICS.timed("dev_msa"):
            results = self._device_msa.consensus_batch(regions)
        from .ops.poa_profile import profile_consensus

        m = self.mtp
        for ri, r in enumerate(results):
            if r is None:
                METRICS.add("host_cap_msa")
                results[ri] = profile_consensus(
                    regions[ri], m.match, m.mismatch, m.gap_open1,
                    m.gap_ext1, polish=getattr(m, "polish", 0),
                    gap_open2=m.gap_open2, gap_ext2=m.gap_ext2,
                )
        return results

    # --- chunk processing ---
    #
    # Split into prepare (host: encode/seed/chain) and finish (device
    # rounds + consensus) so the runner can overlap chunk N+1's host work
    # with chunk N's device work.

    def prepare_chunk(self, chunk, mtp: Params):
        """Stage 1: seed + chain. The native chain DP (ctypes) releases
        the GIL, and seeding is NumPy-releasing too, so the reference's
        read-parallel threading model (src/main.c:273-291) maps onto a
        plain thread pool here.

        Device seeding (ops/seeding_jax.py) replaces the host seeder when
        a mesh is installed or TH_DEVICE_SEED=1: with N cards per host the
        host threads become the feed bottleneck, so seeding moves to the
        cards (bit-exact, tests/test_seeding_jax.py).  Single-card default
        stays host-side — there host seeding rides the pipelined overlap
        with the previous chunk's device work."""
        device_hits = None
        device_chains = None
        use_dev_seed = (
            self.mesh is not None
            or os.environ.get("TH_DEVICE_SEED", "") == "1"
        )
        if use_dev_seed:
            with METRICS.timed("device_seed"):
                device_hits, device_chains = self._device_seed(chunk, mtp)

        bseqs = [None] * len(chunk)
        read_chains = [None] * len(chunk)

        def _seed_chain(ri_rec):
            ri, rec = ri_rec
            if len(rec.seq) < mtp.k:
                read_chains[ri] = (None, [])
                return
            bseq = encode(rec.seq)
            bseqs[ri] = bseq
            if device_chains is not None and device_chains[ri] is not None:
                read_chains[ri] = device_chains[ri]
                return
            if device_hits is not None:
                ends, periods = device_hits[ri]
            else:
                ends, periods = collect_tandem_repeat_hits(
                    bseq, mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p
                )
            read_chains[ri] = tandem_chain_native(ends, periods, mtp.k)

        with METRICS.timed("seed_chain"):
            # -t keeps the reference's CLI default (4), but threads only
            # help up to the host's core count
            n_workers = max(1, min(
                int(getattr(mtp, "n_thread", 1) or 1),
                os.cpu_count() or 1,
            ))
            if n_workers > 1 and len(chunk) > 1:
                from concurrent.futures import ThreadPoolExecutor

                if self._pool is None or self._pool_n != n_workers:
                    if self._pool is not None:
                        self._pool.shutdown(wait=False)
                    self._pool = ThreadPoolExecutor(max_workers=n_workers)
                    self._pool_n = n_workers
                list(self._pool.map(_seed_chain, enumerate(chunk)))
            else:
                for item in enumerate(chunk):
                    _seed_chain(item)
        # partition walks are pure host work when the native kernel
        # serves them (the single-card default): doing them HERE instead
        # of in finish_chunk lets the pipelined runner overlap chunk
        # N+1's walks with chunk N's device consensus rounds — in
        # finish_chunk they sat on the critical path idling the device
        # between chunks. Walks that defer to the batched device drive
        # (oversize windows, or the mesh path) stay in finish_chunk.
        walked = None
        if self._use_native_walks():
            walked = self._partition_chunk(chunk, bseqs, read_chains, mtp)
        return chunk, bseqs, read_chains, walked

    def _device_seed(self, chunk, mtp: Params):
        """One batched device seeding call for the whole chunk.

        Fast path (ops/offload.py, default whenever the packed-key
        envelope fits — k <= 8-ish at these read lengths): ONE fused
        seed+chain dispatch, packed 4-bases/byte upload, two packed
        result planes pulled once.  TH_OFFLOAD_V1=1 forces the round-4
        separate-dispatch path below (kept as the general-envelope
        fallback: k up to 16, reads past the packed-position range).

        Shapes stay finite: L pads to the read-length ladder
        (offload.len_bucket — pow2 + 1.5x midpoints) or the next power of
        two (v1), and B to the next multiple of 64 * mesh_n; rows shard
        over the 'dp' mesh when installed (row-independent sort dataflow
        — no collectives)."""
        from .ops import offload

        maxL = max((len(r.seq) for r in chunk), default=1)
        if (
            os.environ.get("TH_OFFLOAD_V1", "") != "1"
            and offload.supported(mtp.k, maxL)
        ):
            bseqs = [
                encode(rec.seq) if len(rec.seq) >= mtp.k else None
                for rec in chunk
            ]
            # hybrid default: device seeds, the prepare pool chains
            # (native C, GIL-releasing, overlaps device work);
            # TH_DEVICE_CHAIN=1 moves the full-window chain DP to the
            # device for hosts that cannot chain for all their cards.
            chain_mode = (
                "device"
                if os.environ.get("TH_DEVICE_CHAIN", "") == "1"
                else "host"
            )
            hits, chains = offload.device_seed_chain(
                bseqs, mtp, mesh=self.mesh, chain_mode=chain_mode)
            return hits, chains

        import jax.numpy as jnp

        from .ops.seeding_jax import collect_hits_batch

        n = len(chunk)
        g = 64 * (1 if self.mesh is None else int(self.mesh.devices.size))
        B = max(g, -(-n // g) * g)
        maxL = max((len(r.seq) for r in chunk), default=1)
        L = 1024
        while L < maxL:
            L *= 2
        batch = np.full((B, L), 4, np.uint8)
        lens = np.zeros(B, np.int32)
        for i, rec in enumerate(chunk):
            b = encode(rec.seq)
            batch[i, : len(b)] = b
            lens[i] = len(b)
        args = (jnp.asarray(batch), jnp.asarray(lens))
        if self.mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            s = NamedSharding(self.mesh, P("dp"))
            args = tuple(jax.device_put(a, s) for a in args)
        ends_d, periods_d, cnt_d, fb_d = collect_hits_batch(
            *args, k=mtp.k, use_hpc=bool(mtp.hpc),
            min_p=mtp.min_p, max_p=mtp.max_p, w=mtp.w,
        )
        cnt = np.asarray(cnt_d)
        fb = np.asarray(fb_d)

        # Device chain DP over the still-resident hit matrices (VERDICT r2
        # item 2): bucket hit capacity to the next power of two and run the
        # windowed scan with window == bucket, which makes every non-gated
        # row bit-exact (ops/chaining_jax.py). Host post-processing
        # (tandem_chain_from_dp -> native th_chain_post) touches only the
        # ~1-3 selected chains per read. Default on under a mesh (the
        # host chains for every card there); opt-in/out anywhere via
        # TH_DEVICE_CHAIN.
        dev_chain_env = os.environ.get("TH_DEVICE_CHAIN", "")
        use_dev_chain = (
            dev_chain_env == "1"
            or (dev_chain_env != "0" and self.mesh is not None)
        )
        score = from_idx = fb_c = None
        # size the hit window from rows the device DP will actually serve:
        # seed-fallback rows hold garbage counts, and a single oversize row
        # (> 8192 hits) must reroute to the host chainer alone, not turn
        # device chaining off for the whole chunk
        cnt_ok = np.where(fb, 0, cnt)
        oversize = cnt_ok > 8192
        max_hits = int(np.where(oversize, 0, cnt_ok).max()) if n else 0
        if use_dev_chain and max_hits >= 2:
            from .ops.chaining_jax import chain_dp_batch

            Lh = 512
            while Lh < max_hits:
                Lh *= 2
            with METRICS.timed("device_chain"):
                score_d, from_d, fbc_d = chain_dp_batch(
                    ends_d[:, :Lh], periods_d[:, :Lh],
                    jnp.minimum(cnt_d, Lh), k=mtp.k, window=Lh,
                )
                score = np.asarray(score_d).astype(np.int64)
                from_idx = np.asarray(from_d).astype(np.int64)
                fb_c = np.asarray(fbc_d) | oversize

        ends = np.asarray(ends_d)
        periods = np.asarray(periods_d)
        hits_list = []
        chains_list = [None] * n
        for i in range(n):
            if fb[i]:
                # device-flagged reads (w>1 outside the two-pass
                # preconditions) reroute through the exact host seeder
                hits_list.append(collect_tandem_repeat_hits(
                    encode(chunk[i].seq), mtp.k, mtp.w, mtp.hpc,
                    mtp.min_p, mtp.max_p))
                continue
            e = ends[i, : cnt[i]].astype(np.int64)
            p = periods[i, : cnt[i]].astype(np.int64)
            hits_list.append((e, p))
            if score is not None and not fb_c[i]:
                c = int(cnt[i])
                if c < 2:
                    chains_list[i] = (None, [])
                else:
                    chains_list[i] = tandem_chain_from_dp(
                        e, p, score[i, :c], from_idx[i, :c], mtp.k
                    )
        return hits_list, chains_list

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_n = 0
        if self._gx_pool is not None:
            self._gx_pool.shutdown(wait=False)
            self._gx_pool = None

    def process_chunk(self, chunk, mtp: Params) -> List[TandemResult]:
        return self.finish_chunk(self.prepare_chunk(chunk, mtp), mtp)

    __call__ = process_chunk

    def _use_native_walks(self) -> bool:
        """single-card: resolve walks on the host (a device round per
        ~34 bp walk step would buy a ~2 us DP). Under a mesh the walks
        return to the breadth-first device drive, which amortizes each
        round across the whole sharded chunk (override with
        TH_HOST_WALK=1/0)."""
        from .ops.ksw2_native import available as _native_ok

        hw_env = os.environ.get("TH_HOST_WALK", "")
        return _native_ok() and (
            hw_env == "1" or (hw_env != "0" and self.mesh is None)
        )

    def _partition_chunk(self, chunk, bseqs, read_chains, mtp: Params):
        """Stage 2 (host part): partition walks. The walk's alignments
        are tiny (anchor-gap sized, ~34 bp mean on the headline
        workload), so when the native small-alignment kernel is
        available each walk resolves SYNCHRONOUSLY on the host — zero
        device rounds for the whole stage (a breadth-first device drive
        here costs one device round per walk step). A walker that
        yields an oversize request defers, mid-walk, to the batched
        breadth-first device drive in finish_chunk (left/right halves
        stay independent walkers there).

        Returns (halves, walkers, walker_meta, chain_objs); `walkers`
        holds only the deferred generators (empty on the non-native
        path is impossible — callers gate on _use_native_walks)."""
        from .ops.ksw2_native import global_tleft_one, walk_right_native

        use_native = self._use_native_walks()
        cap = self.aligner.host_aln_cap
        walkers = []
        walker_meta = []
        halves: Dict[Tuple[int, int, int], List[int]] = {}
        chain_objs: Dict[Tuple[int, int], object] = {}
        with METRICS.timed("partition"):
            for ri, rec in enumerate(chunk):
                dp, chains = read_chains[ri]
                for ci, ch in enumerate(chains):
                    chain_objs[(ri, ci)] = ch
                    cells = np.asarray(ch.cells)
                    starts_a = dp.start[cells]
                    ends_a = dp.end[cells]
                    if use_native and ch.est_ch_i == 0:
                        # whole walk in C. The left half is provably
                        # empty when est_ch_i == 0 (partition.py:59 loop
                        # guard) — the live pipeline's only case
                        # (reference src/tandem_chain.c:398).
                        pos = walk_right_native(
                            bseqs[ri], starts_a, ends_a,
                            ch.est_start, ch.est_period,
                            mtp.k, mtp.max_div, cap,
                        )
                        if pos is not None:
                            halves[(ri, ci, 0)] = []
                            halves[(ri, ci, 1)] = pos
                            METRICS.add("walk_native")
                            continue
                    coords = (starts_a.tolist(), ends_a.tolist())
                    for side, walk in (
                        (0, partition_walk_left),
                        (1, partition_walk_right),
                    ):
                        key = (ri, ci, side)
                        gen = walk(
                            bseqs[ri], len(rec.seq), dp, ch,
                            mtp.k, mtp.max_div, coords,
                        )
                        if not use_native:
                            walkers.append(gen)
                            walker_meta.append(key)
                            continue
                        n_aln = 0
                        try:
                            req = gen.send(None)
                            while True:
                                q_, t_, qle_ = req
                                if max(len(q_), len(t_)) > cap:
                                    walkers.append(_resume_walk(gen, req))
                                    walker_meta.append(key)
                                    break
                                n_aln += 1
                                req = gen.send(
                                    global_tleft_one(q_, t_, qle_))
                        except StopIteration as stop:
                            halves[key] = stop.value
                            METRICS.add("host_aln", n_aln)
        return halves, walkers, walker_meta, chain_objs

    def finish_chunk(self, prepared, mtp: Params) -> List[TandemResult]:
        chunk, bseqs, read_chains, walked = prepared
        results = [TandemResult() for _ in chunk]

        # stage 2: partition walks — host-walked in prepare_chunk on the
        # single-card native path (so they overlap the previous chunk's
        # device rounds); computed here otherwise. Deferred oversize
        # walkers resolve through the batched device drive either way.
        if walked is None:
            walked = self._partition_chunk(chunk, bseqs, read_chains, mtp)
        halves, walkers, walker_meta, chain_objs = walked
        with METRICS.timed("partition"):
            holder: Dict[int, List[int]] = {}

            def resolve_global(reqs):
                return self.aligner.run_global(reqs)

            if walkers:
                _drive_collect(walkers, resolve_global, holder)
            for wi, key in enumerate(walker_meta):
                halves[key] = holder.get(wi)
        par_results: Dict[Tuple[int, int], List[int]] = {}
        for (ri, ci), ch in chain_objs.items():
            par_results[(ri, ci)] = combine_walks(
                halves[(ri, ci, 0)], halves[(ri, ci, 1)], ch
            )

        # stage 3: consensus. One generator PER (read, chain), all driven
        # concurrently — a read's later chains would otherwise reach
        # their 'msa' requests only after its first chain's consensus
        # completed, creating tiny straggler MSA batches (each paying a
        # full sequential unit-round wave). Each chain writes into its
        # own buffer; buffers replay through add_cons in chain order
        # afterwards, so record order and the admission filters
        # (write_tandem_cons_seq incl. -l) see the reference sequence.
        consensus_gens = []
        buffers: Dict[int, List[TandemResult]] = {}
        for ri, rec in enumerate(chunk):
            dp, chains = read_chains[ri]
            buffers[ri] = []
            for ci in range(len(chains)):
                par_pos = par_results[(ri, ci)]
                if par_pos is None or len(par_pos) < mtp.min_copy + 1:
                    continue
                buf = _BufferResult()
                buffers[ri].append(buf)
                consensus_gens.append(
                    _chain_consensus_gen(
                        len(rec.seq), bseqs[ri], par_pos, buf, mtp
                    )
                )
        with METRICS.timed("consensus"):
            # Wave-split drive (opt-in): round-robin the generators into
            # TH_DRIVE_WAVES independent lockstep drives on threads, so
            # wave A's wavefront phase (gidens/gx) overlaps wave B's MSA
            # phase on the device — the phases serialize within one drive
            # by data dependency, but not across reads.  Results are
            # per-generator buffers, so splitting cannot reorder output.
            # Default 1 (not measured on the GPU yet).
            waves = int(os.environ.get("TH_DRIVE_WAVES", "1") or 1)
            if (waves > 1 and self.kernels
                    and len(consensus_gens) > 4 * waves):
                import threading

                parts = [consensus_gens[i::waves] for i in range(waves)]
                errs: List = []

                def _run(p):
                    try:
                        _drive(p, self._resolve_batch)
                    except BaseException as e:  # propagate to caller
                        errs.append(e)

                ts = [threading.Thread(target=_run, args=(p,))
                      for p in parts if p]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if errs:
                    raise errs[0]
            else:
                _drive(consensus_gens, self._resolve_batch)
        for ri in range(len(chunk)):
            for buf in buffers[ri]:
                for kind_, a_, b_ in buf.calls:
                    if kind_ == "cons":
                        results[ri].add_cons(a_, b_)
                    else:
                        results[ri].add_unit(a_)

        # stage 4: single-copy full-length — batched device Myers: all
        # reads' adapter searches resolve in two 'hws' rounds
        if (
            mtp.single_copy
            and mtp.only_full_length
            and mtp.five_seq is not None
            and mtp.three_seq is not None
        ):
            with METRICS.timed("single_copy"):
                sc_gens = [
                    single_copy_full_len_gen(rec.seq, results[ri], mtp)
                    for ri, rec in enumerate(chunk)
                ]
                _drive(sc_gens, self._resolve_batch)
        return results


class _BufferResult:
    """Captures add_cons/add_unit calls for ordered replay (stage 3)."""

    def __init__(self) -> None:
        self.calls: List[Tuple] = []

    def add_cons(self, rec, mtp) -> None:
        self.calls.append(("cons", rec, mtp))

    def add_unit(self, sub_pos) -> None:
        self.calls.append(("unit", sub_pos, None))


def _chain_consensus_gen(seq_len, bseq, par_pos, result, mtp):
    yield from seqs_msa_gen(seq_len, bseq, par_pos, result, mtp)


def _resume_walk(gen, first_req):
    """Adapter for a generator already advanced to its first request:
    re-yields that request, then delegates (used when a synchronously
    resolved walk hits an oversize alignment and defers to the batched
    device drive)."""
    res = yield first_req
    while True:
        try:
            req = gen.send(res)
        except StopIteration as stop:
            return stop.value
        res = yield req


def _drive_collect(gens, resolver, holder: Dict[int, object]) -> None:
    pending: Dict[int, object] = {}
    for gi, gen in enumerate(gens):
        try:
            pending[gi] = gen.send(None)
        except StopIteration as stop:
            holder[gi] = stop.value
    while pending:
        keys = list(pending.keys())
        answers = resolver([pending[kk] for kk in keys])
        pending = {}
        for kk, ans in zip(keys, answers):
            try:
                pending[kk] = gens[kk].send(ans)
            except StopIteration as stop:
                holder[kk] = stop.value


def make_engine(mtp: Params, platform: str = "gpu", mesh=None,
                msa_mode: str = "profile", interpret: bool = False) -> Engine:
    """Returns the Engine; it is callable as process_chunk(chunk, mtp) and
    additionally exposes prepare_chunk/finish_chunk for the pipelined
    runner (host work of chunk N+1 overlaps device work of chunk N).

    mesh: explicit 1-D 'dp' Mesh, or None to auto-build one over all
    local devices when more than one is visible (TH_MESH=n overrides the
    device count; TH_MESH=1 disables auto-meshing; TH_MESH=-n forces an
    n-device mesh even for n=1)."""
    check_backend(platform, interpret)
    if mesh is None:
        import jax

        n = int(os.environ.get("TH_MESH", "0")) or len(jax.devices())
        if n > 1 or n < 0:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(abs(n))
    engine = Engine(mtp, platform, msa_mode=msa_mode, mesh=mesh,
                    interpret=interpret)
    log(
        f"device engine ready (platform={platform}"
        + (f", mesh=dp:{mesh.devices.size}" if mesh is not None else "")
        + ")"
    )
    return engine
