"""Seeded synthetic concatemeric long reads (R2C2-style) for smoke runs,
benchmarks and tests.

A read is a random flank, `copies` noisy copies of one random unit, and
another flank.  Each unit base is independently deleted, preceded by an
inserted base, or substituted, each with probability err/3.  Generation
is vectorised per copy, so thousands of reads take about a second.
"""

from __future__ import annotations

import numpy as np

from ..io.codec import decode, encode, revcomp_str


def mutate(rng, unit: np.ndarray, err: float) -> np.ndarray:
    unit = np.asarray(unit, np.uint8)
    r = rng.random(len(unit))
    rand = rng.integers(0, 4, len(unit)).astype(np.uint8)
    keep = r >= err / 3
    ins = keep & (r < 2 * err / 3)
    base = np.where(keep & ~ins & (r < err), rand, unit)
    n_out = keep.astype(np.int64) + ins
    start = np.cumsum(n_out) - n_out
    out = np.empty(int(n_out.sum()), np.uint8)
    out[start[ins]] = rand[ins]              # inserted base, then the base
    out[start[keep] + ins[keep]] = base[keep]
    return out


def synth_read(rng, unit_len: int = 450, copies: int = 9, err: float = 0.10,
               flank: int = 150, unit: np.ndarray | None = None) -> str:
    if unit is None:
        unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, flank).astype(np.uint8)]
    for _ in range(copies):
        parts.append(mutate(rng, unit, err))
    parts.append(rng.integers(0, 4, flank).astype(np.uint8))
    return decode(np.concatenate(parts))


def random_seq(rng, n: int) -> str:
    return decode(rng.integers(0, 4, n).astype(np.uint8))


def synth_full_length_read(rng, five: str, three: str, insert_len: int,
                           copies: int, err: float, flank: int) -> str:
    """R2C2 full-length layout: each copy is the 5' adapter, the insert
    and the reverse complement of the 3' adapter (the anti-sense strand
    sequence the CLI's -3 takes)."""
    unit = np.concatenate([
        encode(five), rng.integers(0, 4, insert_len).astype(np.uint8),
        encode(revcomp_str(three))]).astype(np.uint8)
    return synth_read(rng, copies=copies, err=err, flank=flank, unit=unit)
