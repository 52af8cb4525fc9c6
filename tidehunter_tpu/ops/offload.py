"""Fused device seeding offload: one dispatch seeds a whole chunk.

Used under a multi-card mesh (and with TH_DEVICE_SEED=1), where the host
would otherwise seed for every card.  The layout keeps transfers and the
sort small:

  * upload: reads go to the device at 4 bases/byte in quarter-block
    layout (unpack = lane concat, no relayout); rows containing N are
    flagged host-side and rerouted to the exact host seeder (reference
    semantics are N-reset anyway, tandem_hit.c:42-44)
  * seed: ops/seeding_jax.collect_hits_packed — single-uint32-key sort +
    branchless binary search (the host oracle's own searchsorted
    dataflow) instead of a 2L-record merge
  * pull: ONE uint32 plane (end << pos_bits | period — also the
    (end, period) sort order, so it doubles as the compaction) + meta
  * chain: HYBRID by default — the chain DP stays on the host
    (native/chainx.c, GIL-releasing so it overlaps device work through
    the engine's thread pool).  Error-gapped copies pair 2-8 periods
    back, so a windowed device chain cannot be per-read exact below the
    full window
  * chain_mode="device": the full-window chain DP on device
    (exactness-guaranteed at window == hit capacity), pulled as ONE
    int32 plane (score << shift | from-delta) — for meshes whose host
    cannot chain for all cards

Everything is row-independent, so under a 1-D 'dp' mesh the batch shards
over cards with zero collectives (the pthread fan-out role of reference
src/main.c:273-291).  Whether the packed transfers pay over PCIe has not
been measured on the GPU.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from .seeding import collect_tandem_repeat_hits
from .seeding_jax import collect_hits_packed, packed_ok, pos_bits


# read-length ladder: pow2 plus 1.5x midpoints — the round-4 pow2-only
# rule padded 4.4 kb reads to 8192 (46% waste on every downstream term)
def len_bucket(n: int) -> int:
    L = 1024
    while L < n:
        L += L // 2 if (L & (L - 1)) == 0 else L // 3
    return L


def sf_shift(window: int) -> int:
    """Bits reserved for the from-delta field (delta in [0, window])."""
    return int(window).bit_length()


def supported(k: int, maxL: int) -> bool:
    """Static gate for the fused path: the packed-key seeder must fit."""
    return packed_ok(k, len_bucket(maxL))


def _sf_fits(k: int, hit_cap: int) -> bool:
    """Score (< 2k * hit_cap) and from-delta pack into one int32."""
    return 2 * k * hit_cap < (1 << (31 - sf_shift(hit_cap)))


@functools.lru_cache(maxsize=None)
def _fused(k: int, use_hpc: bool, min_p: int, max_p: int, w: int,
           L: int, hit_cap: int, with_chain: bool):
    """Builds the jitted fused dispatch for one static config."""
    import jax
    import jax.numpy as jnp

    from .chaining_jax import chain_dp_batch

    pb = pos_bits(L)
    pmask = jnp.int32((1 << pb) - 1)
    shift = sf_shift(hit_cap)

    @jax.jit
    def run(packed, length):
        b = packed
        # quarter-block layout (pack_reads): byte j holds bases
        # j, j+L/4, j+L/2, j+3L/4 — unpack is a pure lane CONCAT.  The
        # interleaved layout (base i in byte i//4) lowered to a lane
        # relayout that cost 0.8 ms/read on hardware
        # (evals/hw_r05/offload_micro2.log "unpack (device)").
        bases = jnp.concatenate(
            [b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], axis=1)
        idx = jnp.arange(L, dtype=jnp.int32)[None, :]
        bases = jnp.where(idx < length[:, None], bases, jnp.uint8(4))
        ph, n_hits, fb = collect_hits_packed(
            bases, length, k=k, use_hpc=use_hpc,
            min_p=min_p, max_p=max_p, w=w)
        phc = ph[:, :hit_cap]
        over = n_hits > hit_cap
        if not with_chain:
            meta = jnp.stack(
                [n_hits, fb.astype(jnp.int32), jnp.zeros_like(n_hits),
                 over.astype(jnp.int32)], axis=1)
            return phc.astype(jnp.int32), meta
        ends = (phc >> pb).astype(jnp.int32)
        periods = phc.astype(jnp.int32) & pmask
        ncl = jnp.minimum(n_hits, hit_cap)
        # window == hit_cap: every window sees the front pad, so an event
        # always fires and the DP is exactness-guaranteed (fbc covers
        # only the envelope gates — non-singleton groups etc.)
        score, from_idx, fbc = chain_dp_batch(
            ends, periods, ncl, k=k, window=hit_cap)
        lane = jnp.arange(hit_cap, dtype=jnp.int32)[None, :]
        delta = jnp.where(from_idx >= 0, lane - from_idx, 0)
        sf = (score << shift) | delta
        meta = jnp.stack(
            [n_hits, fb.astype(jnp.int32), fbc.astype(jnp.int32),
             over.astype(jnp.int32)], axis=1)
        return phc.astype(jnp.int32), sf, meta

    return run


def pack_reads(
    bseqs: List[Optional[np.ndarray]], B: int, L: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host packing: [B, L//4] uint8 (4 bases/byte, quarter-block layout),
    lengths, has-N flags.  bseqs entries may be None (too-short reads) —
    left as zero rows."""
    arr = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    has_n = np.zeros(B, bool)
    for i, bs in enumerate(bseqs):
        if bs is None:
            continue
        n = len(bs)
        lens[i] = n
        if (bs >= 4).any():
            has_n[i] = True
            continue  # row reroutes to the host seeder; leave zeros
        arr[i, :n] = bs
    Q = L // 4
    packed = (arr[:, :Q] | (arr[:, Q:2 * Q] << 2)
              | (arr[:, 2 * Q:3 * Q] << 4) | (arr[:, 3 * Q:] << 6))
    return packed, lens, has_n


def device_seed_chain(
    bseqs: List[Optional[np.ndarray]],
    mtp,
    mesh=None,
    chain_mode: str = "host",
):
    """Engine entry: one fused dispatch + one overlapped pull per chunk.

    Returns (hits_list, chains_list) with the same contract as
    Engine._device_seed: hits_list[i] = (ends, periods) int64 arrays;
    chains_list[i] = (dp, chains), or None meaning the caller should run
    the host chainer on hits_list[i] (the hybrid default — the engine's
    prepare pool does exactly that, overlapping device work).
    """
    import jax
    import jax.numpy as jnp

    from .chaining_native import tandem_chain_from_dp, tandem_chain_native
    from ..utils.metrics import METRICS

    n = len(bseqs)
    g = 64 * (1 if mesh is None else int(mesh.devices.size))
    B = max(g, -(-n // g) * g)
    maxL = max((len(b) for b in bseqs if b is not None), default=1)
    L = len_bucket(maxL)
    hit_cap = L // 2
    pb = pos_bits(L)
    pmask = (1 << pb) - 1
    with_chain = chain_mode == "device" and _sf_fits(mtp.k, hit_cap)
    shift = sf_shift(hit_cap)
    dmask = (1 << shift) - 1

    packed, lens, has_n = pack_reads(bseqs, B, L)
    args = (jnp.asarray(packed), jnp.asarray(lens))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        s = NamedSharding(mesh, P("dp"))
        args = tuple(jax.device_put(a, s) for a in args)
    run = _fused(mtp.k, bool(mtp.hpc), mtp.min_p, mtp.max_p, mtp.w,
                 L, hit_cap, with_chain)
    outs = run(*args)
    for a in outs:
        try:
            a.copy_to_host_async()  # overlap the pulls' round trips
        except AttributeError:
            pass
    outs = jax.device_get(outs)
    if with_chain:
        ph, sf, meta = outs
    else:
        ph, meta = outs
        sf = None

    hits_list: List = [None] * n
    chains_list: List = [None] * n
    lanes = np.arange(hit_cap, dtype=np.int64)
    for i in range(n):
        if bseqs[i] is None:
            hits_list[i] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            chains_list[i] = (None, [])
            continue
        cnt, fb_seed, fb_chain, over = meta[i]
        if has_n[i] or fb_seed or over:
            METRICS.add("offload_seed_fb")
            e, p = collect_tandem_repeat_hits(
                bseqs[i], mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
            hits_list[i] = (e, p)
            continue  # chains_list[i] = None -> caller's host chainer
        row = ph[i, :cnt].astype(np.int64)
        e = row >> pb
        p = row & pmask
        hits_list[i] = (e, p)
        if sf is None:
            continue  # hybrid: host chainer (caller)
        if cnt < 2:
            chains_list[i] = (None, [])
        elif fb_chain:
            # envelope gate (non-singleton end group / value range):
            # host chainer on the pulled hits
            METRICS.add("offload_chain_fb")
            chains_list[i] = tandem_chain_native(e, p, mtp.k)
        else:
            srow = sf[i, :cnt].astype(np.int64)
            score = srow >> shift
            delta = srow & dmask
            from_idx = np.where(delta > 0, lanes[:cnt] - delta, -1)
            chains_list[i] = tandem_chain_from_dp(
                e, p, score, from_idx, mtp.k)
    return hits_list, chains_list
