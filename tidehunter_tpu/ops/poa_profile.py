"""Profile-POA consensus: the accelerator-native reformulation of abPOA.

Instead of a partial-order GRAPH grown per unit (host oracle, ops/poa.py),
the MSA state is a column PROFILE: per column, base counts and occupancy.
Each unit is aligned to the profile with an affine-gap Gotoh DP whose
per-column scores encode what the POA graph encodes structurally:

  * substitution vs column c = occupancy-averaged vote of the units placed
    there (a fresh inserted column scores like a normal base for the unit
    that introduced it)
  * deleting column c costs gap_ext scaled by occ[c]/n_placed — skipping a
    column most units skip is nearly free, exactly like taking the bypass
    edge in the POA graph
  * insertions open new columns, so later units can support them in place
    (this is what fixes the star-MSA's insertion-vote splitting)

All quantities are fixed-point ints (SCALE) so the device kernel
(ops/msa_device.py) matches this reference bit-for-bit. The per-row
recurrence is scan-friendly: M and I are elementwise; the weighted deletion
track is F[c] = cummax(G[c'] + W[c'])_{c'<c} - O - W[c] with W = prefix sums
of the column weights — one cummax per row on device.

Consensus rule (abPOA RC contract, reference src/abpoa_cons.c): majority
base per column, column dropped when gaps outnumber the best base,
coverage = count of units with the consensus base.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SCALE = 16
NEG = -(1 << 30)

# Band window ladder shared by the device kernels (ops/msa_device.py) and
# the host mirror below: a region runs at the narrowest eligible window,
# escalating one rung on band-touch, with the full-width kernel as the
# last rung.  DP cost is rows * W, so W=128 beats the full kernel ~T/128x.
BAND_LADDER = (128, 256, 512)


def band_ladder(T: int, spread: int) -> list:
    """Attempt sequence of window widths for a region whose unit lengths
    span `spread` in bucket T: eligible band rungs ascending, then None
    (= full kernel).  A rung W gives half-band wb = W - 8; unit lengths
    differing by more than wb/2 guarantee a band touch, so those rungs
    are skipped up front."""
    return [w for w in BAND_LADDER
            if w < T and spread <= (w - 8) // 2] + [None]


class Profile:
    def __init__(self, unit: np.ndarray):
        n = len(unit)
        self.counts = np.zeros((n, 5), np.int64)
        self.counts[np.arange(n), unit] = 1
        self.n_placed = 1

    @property
    def ncol(self) -> int:
        return self.counts.shape[0]

    def occ(self) -> np.ndarray:
        return self.counts.sum(axis=1)

    def sub_scores(self, match: int, mismatch: int) -> np.ndarray:
        """[ncol, 5] fixed-point substitution scores (occupancy-averaged)."""
        occ = np.maximum(self.occ(), 1)[:, None]
        raw = SCALE * (
            (match + mismatch) * self.counts - mismatch * occ
        )
        return raw // occ  # match*cnt - mismatch*(occ-cnt), averaged

    def del_weights(self, gap_ext: int) -> np.ndarray:
        """[ncol] fixed-point per-column deletion extension cost (one
        track; call once per gap-extension penalty for dual-affine)."""
        occ = self.occ()
        return (SCALE * gap_ext * occ) // self.n_placed

    def update_arrays(
        self, unit: np.ndarray, ops: np.ndarray, cols: np.ndarray, qpos: np.ndarray
    ) -> None:
        """Vectorized update from op-code arrays (0=M 1=I 2=D, left-to-right).

        A global alignment path consumes every profile column exactly once
        (M/D) and every I step opens a new column, so the new column layout
        IS the step sequence — one gather of old columns plus one scatter of
        the unit's bases."""
        n_steps = len(ops)
        new = np.zeros((n_steps, 5), np.int64)
        step_idx = np.arange(n_steps)
        old = ops != 1  # M or D: carries an existing column
        new[step_idx[old]] = self.counts[cols[old]]
        has_base = ops != 2  # M or I: the unit contributes a base
        new[step_idx[has_base], unit[qpos[has_base]]] += 1
        self.counts = new
        self.n_placed += 1

    def update(self, unit: np.ndarray, ops) -> None:
        """Apply an alignment path: ops = [(kind, col, qpos)] left-to-right,
        kind 'M' (unit[qpos] at column col), 'D' (column skipped),
        'I' (unit[qpos] inserted after column col; col = -1 for front)."""
        # group insertions to build the new column layout in one pass
        ins_after: dict = {}
        for kind, col, qpos in ops:
            if kind == "I":
                ins_after.setdefault(col, []).append(qpos)
        if ins_after:
            old = self.counts
            ncol_new = old.shape[0] + sum(len(v) for v in ins_after.values())
            new = np.zeros((ncol_new, 5), np.int64)
            remap = np.zeros(old.shape[0], np.int64)
            w = 0
            for front_q in ins_after.get(-1, []):
                new[w, unit[front_q]] = 1
                w += 1
            for c in range(old.shape[0]):
                new[w] = old[c]
                remap[c] = w
                w += 1
                for q in ins_after.get(c, []):
                    new[w, unit[q]] = 1
                    w += 1
            self.counts = new
        else:
            remap = np.arange(self.counts.shape[0])
        for kind, col, qpos in ops:
            if kind == "M":
                self.counts[remap[col], unit[qpos]] += 1
        self.n_placed += 1

    def consensus(self) -> Tuple[np.ndarray, np.ndarray]:
        best = self.counts.argmax(axis=1)
        ncol = self.counts.shape[0]
        bc = self.counts[np.arange(ncol), best]
        gaps = self.n_placed - self.counts.sum(axis=1)
        keep = bc > gaps
        return best[keep].astype(np.uint8), bc[keep].astype(np.int64)


def align_to_profile(
    unit: np.ndarray,
    sub: np.ndarray,       # [T, 5] fixed-point substitution scores
    wdel: np.ndarray,      # [T] fixed-point deletion extension costs
    gap_open: int,
    gap_ext: int,
    gap_open2: int | None = None,
    gap_ext2: int | None = None,
    wdel2: np.ndarray | None = None,
    band: int | None = None,
) -> List[Tuple[str, int, int]]:
    """Gotoh DP of unit vs profile; returns the op path for Profile.update.

    band: |c - j| <= band restriction mirroring the device's banded
    kernel exactly (every out-of-band state reads/stores NEG); callers
    must apply the same band-touch + full-retry rule as the device
    driver (see banded_profile_consensus).

    Gap model: single affine by default; pass (gap_open2, gap_ext2,
    wdel2) for the abPOA convex (dual-affine) contract
    min{O1 + g*E1, O2 + g*E2} (reference src/abpoa_cons.c:15-20,
    README.md:154-157) — each gap run commits to one track; the two
    insertion tracks use uniform fixed-point costs and the two deletion
    tracks use per-column occupancy weights via independent prefix-sum
    cummax runs.  Tie order: M, then I (track 1 over track 2), then D
    (track 1 over track 2) — mirrored exactly by the device kernel
    (ops/msa_device.py).
    """
    T = len(wdel)
    Lq = len(unit)
    dual = gap_open2 is not None
    O_i1 = SCALE * gap_open
    E_i1 = SCALE * gap_ext
    O_d1 = SCALE * gap_open
    W1 = np.concatenate(([0], np.cumsum(wdel)))
    if dual:
        O_i2 = SCALE * gap_open2
        E_i2 = SCALE * gap_ext2
        O_d2 = SCALE * gap_open2
        W2 = np.concatenate(([0], np.cumsum(wdel2)))

    def ins_cost(g):
        c1 = O_i1 + g * E_i1
        if dual:
            return np.minimum(c1, O_i2 + g * E_i2)
        return c1

    if Lq == 0:
        return [("D", c, -1) for c in range(T)]

    # H[j][c], c in 0..T; row-major over j
    H = np.empty((Lq + 1, T + 1), np.int64)
    E1 = np.full(T + 1, NEG, np.int64)  # insertion tracks (consume unit)
    E2 = np.full(T + 1, NEG, np.int64)
    # bt bits: 0-1 sel (0=M 1=I 2=D); 2 icont1; 3 icont2; 4 isel2; 5 fsel2
    bt = np.zeros((Lq + 1, T + 1), np.uint8)
    fopen1 = np.zeros((Lq + 1, T + 1), np.int64)
    fopen2 = np.zeros((Lq + 1, T + 1), np.int64)
    cgrid = np.arange(T + 1)
    H[0] = -(O_d1 + W1)
    if dual:
        H[0] = np.maximum(H[0], -(O_d2 + W2))
    H[0, 0] = 0
    if band is not None:
        H[0] = np.where(cgrid <= band, H[0], NEG)

    def _frun(G_row, E0, W, O_d):
        keyed = np.concatenate(([E0], G_row)) + W
        run = np.maximum.accumulate(keyed)
        prev_run = np.concatenate(([NEG], run[:-1]))
        is_new = keyed > prev_run
        idx = np.where(is_new, np.arange(T + 1), -1)
        run_arg = np.maximum.accumulate(idx)
        F = np.full(T + 1, NEG, np.int64)
        F[1:] = run[:-1] - O_d - W[1:]
        return F, np.concatenate(([0], run_arg[:-1]))

    for j in range(1, Lq + 1):
        s = sub[:, unit[j - 1]]
        M = H[j - 1, :-1] + s
        e_open1 = H[j - 1] - O_i1 - E_i1
        e_cont1 = E1 - E_i1
        E1 = np.maximum(e_open1, e_cont1)
        icont1 = e_cont1 > e_open1
        if dual:
            e_open2 = H[j - 1] - O_i2 - E_i2
            e_cont2 = E2 - E_i2
            E2 = np.maximum(e_open2, e_cont2)
            icont2 = e_cont2 > e_open2
            E = np.maximum(E1, E2)
            isel2 = E2 > E1
        else:
            E = E1
            icont2 = np.zeros(T + 1, bool)
            isel2 = np.zeros(T + 1, bool)
        if band is not None:
            inb = np.abs(cgrid - j) <= band
            E1 = np.where(inb, E1, NEG)
            if dual:
                E2 = np.where(inb, E2, NEG)
                E = np.where(inb, E, NEG)
            else:
                E = E1
            M = np.where(inb[1:], M, NEG)
        G = np.maximum(M, E[1:])           # best non-D at c = 1..T
        # first-occurrence argmax (ties -> earliest opener), matching the
        # device kernel's F-continuation tie rule
        F1, fo1 = _frun(G, E[0], W1, O_d1)
        if dual:
            F2, fo2 = _frun(G, E[0], W2, O_d2)
            F = np.maximum(F1, F2)
            fsel2 = F2 > F1
        else:
            F, fo2 = F1, fopen2[0]
            fsel2 = np.zeros(T + 1, bool)
        Hrow = np.empty(T + 1, np.int64)
        Hrow[0] = -ins_cost(j)
        Hrow[1:] = np.maximum(G, F[1:])
        if band is not None:
            Hrow = np.where(inb, Hrow, NEG)
            F1 = np.where(inb, F1, NEG)
            if dual:
                F2 = np.where(inb, F2, NEG)
        # states: ties prefer M, then I, then D
        st = np.zeros(T + 1, np.uint8)
        st[1:] = np.where(F[1:] > G, 2, np.where(E[1:] > M, 1, 0))
        st[0] = 1
        bt[j] = (st | (icont1.astype(np.uint8) << 2)
                 | (icont2.astype(np.uint8) << 3)
                 | (isel2.astype(np.uint8) << 4)
                 | (fsel2.astype(np.uint8) << 5))
        fopen1[j] = fo1
        if dual:
            fopen2[j] = fo2
        H[j] = Hrow

    # backtrack
    ops: List[Tuple[str, int, int]] = []
    j, c = Lq, T
    while j > 0 or c > 0:
        if j == 0:
            ops.append(("D", c - 1, -1))
            c -= 1
            continue
        if c == 0:
            ops.append(("I", -1, j - 1))
            j -= 1
            continue
        s = bt[j, c] & 3
        if s == 0:  # M
            ops.append(("M", c - 1, j - 1))
            j -= 1
            c -= 1
        elif s == 1:  # I run: fix the track at entry, walk continuation
            trk2 = (bt[j, c] >> 4) & 1
            cbit = 3 if trk2 else 2
            ops.append(("I", c - 1, j - 1))
            j -= 1
            while j > 0 and (bt[j + 1, c] >> cbit) & 1:
                ops.append(("I", c - 1, j - 1))
                j -= 1
        else:  # D run to the entry track's opener column
            trk2 = (bt[j, c] >> 5) & 1
            c_open = int((fopen2 if trk2 else fopen1)[j, c])
            while c > c_open:
                ops.append(("D", c - 1, -1))
                c -= 1
    ops.reverse()
    return ops


def profile_consensus(
    units: List[np.ndarray],
    match: int,
    mismatch: int,
    gap_open: int,
    gap_ext: int,
    polish: int = 0,
    gap_open2: int | None = None,
    gap_ext2: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential profile-POA over the units (host reference).

    polish > 0 adds that many frozen-layout refinement rounds: every unit
    is realigned against the FINAL profile's scores and only match votes
    into the existing column layout are counted. This removes the greedy
    backbone bias of sequential placement (the first unit's errors anchor
    early columns) and lifts low-coverage consensus identity ~0.3-0.5%;
    it goes beyond the reference (abPOA does a single sequential pass)."""
    prof = Profile(np.asarray(units[0], np.int64))

    def _wdel2():
        return prof.del_weights(gap_ext2) if gap_open2 is not None else None

    for u in units[1:]:
        u = np.asarray(u, np.int64)
        sub = prof.sub_scores(match, mismatch)
        wdel = prof.del_weights(gap_ext)
        ops = align_to_profile(u, sub, wdel, gap_open, gap_ext,
                               gap_open2, gap_ext2, _wdel2())
        prof.update(u, ops)
    for _ in range(polish):
        sub = prof.sub_scores(match, mismatch)
        wdel = prof.del_weights(gap_ext)
        w2 = _wdel2()
        counts = np.zeros_like(prof.counts)
        for u in units:
            u = np.asarray(u, np.int64)
            ops = align_to_profile(u, sub, wdel, gap_open, gap_ext,
                                   gap_open2, gap_ext2, w2)
            for kind, col, qpos in ops:
                if kind == "M":
                    counts[col, u[qpos]] += 1
        prof.counts = counts
        prof.n_placed = len(units)
    return prof.consensus()


def _path_touches_band(ops, band: int) -> bool:
    """Device touch_step mirror: does the path reach within 8 of the
    |c - j| band edge?  (c/j reconstructed from op cumsums.)"""
    c = j = 0
    for kind, _col, _q in ops:
        if kind != "I":
            c += 1
        if kind != "D":
            j += 1
        if abs(c - j) >= band - 8:
            return True
    return False


def banded_profile_consensus(
    units: List[np.ndarray],
    match: int,
    mismatch: int,
    gap_open: int,
    gap_ext: int,
    polish: int = 0,
    gap_open2: int | None = None,
    gap_ext2: int | None = None,
    buckets=(128, 256, 384, 512, 640, 768, 896, 1024,
             2048, 4096),
) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of ops/msa_device.DeviceMSA.consensus_batch for ONE
    region: same bucket ladder (cap*1.2 margin), same T truncation of
    units and columns, same band-window ladder (band_ladder: W rungs then
    full), same band-touch -> next-rung retry and column-overflow ->
    bucket-up retry.  Bit-identical with the device path, which is the
    production engine's MSA; this is therefore the oracle the engine is
    tested against."""
    cap = max(len(u) for u in units)
    lo = min(len(u) for u in units)
    need = int(cap * 1.2) + 8
    buckets = tuple(sorted(buckets))
    T = next((b for b in buckets if b >= need), None)
    spread = cap - lo
    rung = 0
    while T is not None:
        rungs = band_ladder(T, spread)
        W = rungs[min(rung, len(rungs) - 1)]
        band = None if W is None else W - 8
        prof = Profile(np.asarray(units[0][:T], np.int64))
        overflow = False
        touch = False

        def _one(u, prof, band):
            sub = prof.sub_scores(match, mismatch)
            wdel = prof.del_weights(gap_ext)
            w2 = (prof.del_weights(gap_ext2)
                  if gap_open2 is not None else None)
            return align_to_profile(
                np.asarray(u[:T], np.int64), sub, wdel, gap_open,
                gap_ext, gap_open2, gap_ext2, w2, band=band)

        for u in units[1:]:
            ops = _one(u, prof, band)
            if band is not None and _path_touches_band(ops, band):
                touch = True
                break
            if len(ops) > T:
                overflow = True
                break
            prof.update(np.asarray(u[:T], np.int64), ops)
        if not touch and not overflow:
            for _ in range(polish):
                sub = prof.sub_scores(match, mismatch)
                wdel = prof.del_weights(gap_ext)
                w2 = (prof.del_weights(gap_ext2)
                      if gap_open2 is not None else None)
                counts = np.zeros_like(prof.counts)
                for u in units:
                    ops = align_to_profile(
                        np.asarray(u[:T], np.int64), sub, wdel,
                        gap_open, gap_ext, gap_open2, gap_ext2, w2,
                        band=band)
                    if band is not None and _path_touches_band(ops, band):
                        touch = True
                        break
                    for kind, col, qpos in ops:
                        if kind == "M":
                            counts[col, np.asarray(u[:T])[qpos]] += 1
                if touch:
                    break
                prof.counts = counts
                prof.n_placed = len(units)
        if touch:
            rung += 1          # escalate to the next band rung (or full)
            continue
        if overflow:
            T = next((b for b in buckets if b > T), None)
            rung = 0
            continue
        return prof.consensus()
    # beyond the largest bucket: the device returns no result and the
    # engine falls back to the plain full-width host pass
    return profile_consensus(
        units, match, mismatch, gap_open, gap_ext, polish=polish,
        gap_open2=gap_open2, gap_ext2=gap_ext2)
