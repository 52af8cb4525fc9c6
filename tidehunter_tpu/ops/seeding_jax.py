"""Device seeding: batched k-mer hashing + tandem self-hit generation (JAX).

Bit-exact device counterpart of the host oracle ops/seeding.py (itself
pinned to the reference seeder, reference src/tandem_hit.c:37-237) for the
direct-hash modes (w == 1, with or without HPC).  Minimizer seeding (w > 1)
stays on the host (ops/seeding.py) — its queue algorithm is inherently
sequential and non-default.

Accelerator formulation — everything is fixed-shape sort/scan dataflow, no
data-dependent shapes, 32-bit throughout (JAX runs without x64 by
default, so the reference's 64-bit key<<32|pos radix words are replaced by
multi-operand lexicographic ``lax.sort``):

  1. rolling 2-bit keys over the (optionally HPC-compacted) base stream
     [B, L] via k static shifts; a window is valid iff it holds no N and
     k bases have accumulated (tandem_hit.c:42-56)
  2. self-hit pairing as a MERGE instead of a searchsorted: each valid
     seed contributes one "query" record (key, max(pos-min_p, 0)) next to
     the "original" records (key, pos); one 3-key lexicographic sort of
     the 2L records per read puts every query right after the originals
     it may pair with, and a running last-original scan (cummax) yields
     the nearest earlier same-key occurrence at distance >= min_p —
     exactly the reference's backward scan (tandem_hit.c:191-213)
  3. hits kept iff period <= max_p; final (end, period) lexicographic
     sort reproduces the end:32|period:32 radix order (tandem_hit.c:223)

Outputs are padded [B, L] hit matrices + per-read counts; invalid slots
sort to the tail with INT32_MAX sentinels.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

INT32_MAX = np.int32(2**31 - 1)


def _hpc_compact(bseq: jnp.ndarray, length: jnp.ndarray):
    """Compress homopolymer runs, keeping each run's LAST index.

    bseq: [B, L] uint8 (pad slots hold 4/N beyond `length`).
    Returns (stream [B, L], positions [B, L], stream_len [B]).  Slots past
    stream_len hold base 4 / position INT32_MAX.
    """
    B, L = bseq.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = idx < length[:, None]
    nxt = jnp.concatenate([bseq[:, 1:], jnp.full((B, 1), 255, bseq.dtype)], axis=1)
    nxt_in = jnp.concatenate(
        [in_read[:, 1:], jnp.zeros((B, 1), bool)], axis=1
    )
    keep = in_read & ((bseq != nxt) | ~nxt_in)
    # stable compaction: sort by (not keep) with the position as payload
    sort_key = jnp.where(keep, idx, INT32_MAX)
    pos_sorted, = lax.sort((sort_key,), num_keys=1)
    stream_len = jnp.sum(keep, axis=1).astype(jnp.int32)
    safe = jnp.minimum(pos_sorted, L - 1)
    stream = jnp.where(
        pos_sorted < INT32_MAX,
        jnp.take_along_axis(bseq, safe.astype(jnp.int32), axis=1),
        jnp.uint8(4),
    )
    return stream, pos_sorted, stream_len


def _keys_valid_positions(bseq, length, *, k, use_hpc, w):
    """Shared front half of the seeder: rolling keys + validity mask +
    (minimizer selection when w > 1).  Returns (key [B, L] uint32,
    positions [B, L] int32 read positions, valid [B, L] bool,
    fallback [B] bool)."""
    B, L = bseq.shape
    length = length.astype(jnp.int32)
    if use_hpc:
        stream, positions, stream_len = _hpc_compact(bseq, length)
    else:
        stream = bseq
        positions = jnp.broadcast_to(
            jnp.arange(L, dtype=jnp.int32)[None, :], (B, L)
        )
        stream_len = length

    # --- rolling keys ------------------------------------------------
    # keys are uint32: k is capped at 16 by the reference CLI (2k = 32
    # bits), and JAX runs without x64 by default
    base = jnp.where(stream >= 4, 0, stream).astype(jnp.uint32)
    key = jnp.zeros((B, L), jnp.uint32)
    for o in range(k):
        # base o steps back lands at bits 2o (newest base = low bits,
        # matching the reference's (key << 2 | c) & mask rolling update)
        shifted = jnp.pad(base, ((0, 0), (o, 0)))[:, :L]
        key = key | (shifted << (2 * o))
    is_n = (stream >= 4).astype(jnp.int32)
    csum = jnp.cumsum(is_n, axis=1)
    csum_km1 = jnp.pad(csum, ((0, 0), (k, 0)))[:, :L]  # csum[i-k], 0 for i<k
    window_n = csum - csum_km1
    sidx = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = (sidx >= k - 1) & (sidx < stream_len[:, None]) & (window_n == 0)

    if w > 1:
        in_read = sidx < length[:, None]
        has_n = jnp.any((bseq >= 4) & in_read, axis=1)
        n_seeds = jnp.sum(valid, axis=1)
        fallback = has_n | (n_seeds < w)
        if use_hpc:
            # HPC span rule mirror (minimizer_hash_vec): the first-k-seed
            # guard is the conservative positions[2k-2]+1 bound (it
            # dominates the true span of every seed 0..k-1); later spans
            # are position differences k stream lanes apart
            INF = jnp.int32(1 << 30)
            posc = jnp.minimum(positions, INF)
            first_span = jnp.sum(
                jnp.where(sidx == 2 * k - 2, posc, 0), axis=1) + 1
            pos_km = jnp.pad(posc, ((0, 0), (k, 0)))[:, :L]
            span = posc - pos_km
            span_lane = (sidx >= 2 * k - 1) & (sidx < stream_len[:, None])
            last_pos = jnp.max(
                jnp.where(sidx < stream_len[:, None], posc, -1), axis=1)
            fallback = fallback | jnp.where(
                n_seeds >= k,
                (first_span >= 255)
                | jnp.any(span_lane & (span >= 255), axis=1),
                (n_seeds >= 1) & (last_pos + 1 >= 255))
        # two sliding-extrema passes over the contiguous seed lanes
        # [k-1, stream_len): wm[i] = min key over lanes [i-w+1, i]
        # (valid iff the whole window is seeds), then a k-mer is emitted
        # iff some covering window's minimum equals its key
        UINT32_MAX = jnp.uint32(0xFFFFFFFF)
        okey = jnp.where(valid, key, UINT32_MAX)
        wm = okey
        for o in range(1, w):
            wm = jnp.minimum(
                wm, jnp.pad(okey, ((0, 0), (o, 0)),
                            constant_values=UINT32_MAX)[:, :L])
        wm_ok = (sidx >= k - 1 + w - 1) & (sidx < stream_len[:, None])
        wmz = jnp.where(wm_ok, wm, jnp.uint32(0))
        cover = wmz
        for o in range(1, w):
            cover = jnp.maximum(
                cover, jnp.pad(wmz, ((0, 0), (0, o)))[:, o:])
        valid = valid & (cover == okey)
    else:
        fallback = jnp.zeros(B, bool)
    return key, positions, valid, fallback


@functools.partial(
    jax.jit, static_argnames=("k", "use_hpc", "min_p", "max_p", "w"))
def collect_hits_batch(
    bseq: jnp.ndarray,
    length: jnp.ndarray,
    *,
    k: int,
    use_hpc: bool,
    min_p: int,
    max_p: int,
    w: int = 1,
):
    """Batched collect_tandem_repeat_hit (tandem_hit.c:227-237).

    bseq: [B, L] uint8 encoded reads (0..3 bases, 4 = N; pad with 4).
    length: [B] int32 read lengths.
    Returns (ends [B, L] int32, periods [B, L] int32, n_hits [B] int32,
    fallback [B] bool); rows are sorted by (end, period) with INT32_MAX
    sentinels past n_hits.

    w > 1 runs minimizer seeding via the two sliding-extrema passes of
    the host reformulation (ops/seeding.minimizer_hash_vec): a k-mer is
    emitted iff its key equals the minimum of some window of w
    consecutive k-mers (ties included).  Reads outside that
    reformulation's preconditions — any N, an HPC k-mer span >= 255, or
    fewer than w k-mers — get fallback=True (their rows are garbage) and
    the caller reroutes them through the exact host path.
    """
    B, L = bseq.shape
    key, positions, valid, fallback = _keys_valid_positions(
        bseq, length, k=k, use_hpc=use_hpc, w=w)

    # --- self-hit pairing via merge ----------------------------------
    # records: 2L per read.  sort keys (lexicographic, num_keys=3):
    #   (key', pos', tag)  where originals = (key, pos, 0) for valid seeds
    #   and queries = (key, max(pos - min_p, 0), 1).
    # invalid slots get key' = INT32_MAX so they sink to the tail.
    UINT32_MAX = jnp.uint32(0xFFFFFFFF)
    okey = jnp.where(valid, key, UINT32_MAX)
    opos = jnp.where(valid, positions, INT32_MAX)
    q_ok = valid & (positions >= min_p)
    qkey = jnp.where(q_ok, key, UINT32_MAX)
    qpos_tgt = jnp.where(q_ok, positions - min_p, INT32_MAX)

    mkey = jnp.concatenate([okey, qkey], axis=1)
    mpos = jnp.concatenate([opos, qpos_tgt], axis=1)
    mtag = jnp.concatenate(
        [jnp.zeros((B, L), jnp.int32), jnp.ones((B, L), jnp.int32)], axis=1
    )
    # payload: the original's true pos (originals), query end pos (queries)
    mpay = jnp.concatenate([opos, jnp.where(q_ok, positions, INT32_MAX)], axis=1)
    skey, spos, stag, spay = lax.sort(
        (mkey, mpos, mtag, mpay), num_keys=3
    )

    # running last-original: index into the sorted order of the most recent
    # tag==0 record (cummax of position-index over originals)
    ridx = jnp.arange(2 * L, dtype=jnp.int32)[None, :]
    last_orig = lax.cummax(jnp.where(stag == 0, ridx, -1), axis=1)
    has_orig = last_orig >= 0
    lo = jnp.maximum(last_orig, 0)
    lo_key = jnp.take_along_axis(skey, lo, axis=1)
    lo_pos = jnp.take_along_axis(spos, lo, axis=1)  # original pos' (== payload)

    is_query = (stag == 1) & (spay < INT32_MAX)
    same_key = has_orig & (lo_key == skey)
    period = spay - lo_pos
    hit_ok = is_query & same_key & (period <= max_p)

    ends = jnp.where(hit_ok, spay, INT32_MAX)
    periods = jnp.where(hit_ok, period, INT32_MAX)
    # final (end, period) order; keep first L slots (<= L hits possible:
    # at most one hit per occurrence)
    e_sorted, p_sorted = lax.sort((ends, periods), num_keys=2)
    n_hits = jnp.sum(hit_ok, axis=1).astype(jnp.int32)
    return e_sorted[:, :L], p_sorted[:, :L], n_hits, fallback


def pos_bits(L: int) -> int:
    """Bits needed for a read position in [0, L)."""
    return max(1, int(L - 1).bit_length())


def packed_ok(k: int, L: int) -> bool:
    """The single-uint32-key seeding path fits iff key (2k bits) + pos
    (pos_bits) stay strictly below the 0xFFFFFFFF sentinel, and a hit
    (end, period) pair packs the same way."""
    pb = pos_bits(L)
    return (2 * k + pb <= 31) and (2 * pb <= 31)


def collect_hits_packed(
    bseq: jnp.ndarray,
    length: jnp.ndarray,
    *,
    k: int,
    use_hpc: bool,
    min_p: int,
    max_p: int,
    w: int = 1,
):
    """Packed-key variant of collect_hits_batch for the offload fast path
    (requires packed_ok(k, L)).

    Same semantics, ~4x cheaper sort dataflow: seeds pack into ONE uint32
    (key << pos_bits | pos) so the pairing sort is a single-operand sort
    over L records (not 4 operands over 2L), the nearest-earlier-occurrence
    query is a branchless binary search (13 gathers) — the very dataflow of
    the host oracle (ops/seeding.collect_hits, searchsorted) — and the
    final (end, period) order falls out of one more single-operand sort of
    the packed hits, which doubles as the compact pull format.

    Returns (packed_hits [B, L] uint32 = end << pos_bits | period, sorted
    ascending = (end, period) order with 0xFFFFFFFF sentinels, n_hits [B]
    int32, fallback [B] bool).  NOTE: ends are unique per read (one query
    per position), so the (end, period) sort equals the plain packed sort.
    """
    B, L = bseq.shape
    pb = pos_bits(L)
    pmask = jnp.uint32((1 << pb) - 1)
    UINT32_MAX = jnp.uint32(0xFFFFFFFF)
    key, positions, valid, fallback = _keys_valid_positions(
        bseq, length, k=k, use_hpc=use_hpc, w=w)

    posu = positions.astype(jnp.uint32)
    pk = jnp.where(valid, (key << pb) | posu, UINT32_MAX)
    (so,) = lax.sort((pk,), num_keys=1)

    # rightmost sorted record <= (key, pos - min_p): branchless binary
    # search over counts (cnt = #records <= target; idx = cnt - 1)
    q_ok = valid & (positions >= min_p)
    tgt = jnp.where(
        q_ok, (key << pb) | (posu - jnp.uint32(min_p)), jnp.uint32(0))
    cnt = jnp.zeros((B, L), jnp.int32)
    step = 1 << (L - 1).bit_length()
    while step:
        cand = cnt + step
        v = jnp.take_along_axis(so, jnp.minimum(cand, L) - 1, axis=1)
        ok = (cand <= L) & (v <= tgt)
        cnt = jnp.where(ok, cand, cnt)
        step >>= 1
    found = cnt > 0
    rec = jnp.take_along_axis(so, jnp.maximum(cnt - 1, 0), axis=1)
    same_key = found & ((rec >> pb) == key)
    period = positions - (rec & pmask).astype(jnp.int32)
    hit_ok = q_ok & same_key & (period <= max_p)

    ph = jnp.where(
        hit_ok, (posu << pb) | period.astype(jnp.uint32), UINT32_MAX)
    (ph_sorted,) = lax.sort((ph,), num_keys=1)
    n_hits = jnp.sum(hit_ok, axis=1).astype(jnp.int32)
    return ph_sorted, n_hits, fallback


def collect_hits_batch_host(
    bseqs,
    *,
    k: int,
    w: int,
    use_hpc: bool,
    min_p: int,
    max_p: int,
    pad_to: int | None = None,
):
    """Host convenience wrapper: list of np uint8 reads -> per-read
    (ends, periods) int64 arrays via one device call.  Device-flagged
    reads (w > 1 outside the two-pass preconditions) reroute through the
    exact host path."""
    from .seeding import collect_tandem_repeat_hits

    B = len(bseqs)
    L = max(1, max((len(b) for b in bseqs), default=1))
    if pad_to is not None:
        L = max(L, pad_to)
    batch = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, b in enumerate(bseqs):
        batch[i, : len(b)] = b
        lens[i] = len(b)
    ends, periods, n, fb = collect_hits_batch(
        jnp.asarray(batch), jnp.asarray(lens),
        k=k, use_hpc=use_hpc, min_p=min_p, max_p=max_p, w=w,
    )
    ends = np.asarray(ends)
    periods = np.asarray(periods)
    n = np.asarray(n)
    fb = np.asarray(fb)
    return [
        collect_tandem_repeat_hits(bseqs[i], k, w, use_hpc, min_p, max_p)
        if fb[i] else
        (ends[i, : n[i]].astype(np.int64), periods[i, : n[i]].astype(np.int64))
        for i in range(B)
    ]
