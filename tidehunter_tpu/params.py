"""Parameter set for the tandem-repeat pipeline.

Semantics and defaults mirror the reference parameter struct
``mini_tandem_para`` (reference src/tidehunter.h:9-61) so that a user of the
reference CLI gets identical behavior here, plus device knobs (chunk size,
alignment buckets) that have no reference equivalent.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import IO, Optional

# Defaults: reference src/tidehunter.h:9-41
THREAD_N = 4
# The reference chunks 4096 reads per pthread fan-out (tidehunter.h:10);
# the engine drives one chunk's generators in lockstep while the runner
# prepares the next, and 512-read chunks keep that overlap fine-grained
# (not yet re-tuned on the GPU).  Chunking has no output semantics —
# records stay in input order either way — so this is a pure tuning
# divergence from the reference.
CHUNK_READ_N = 512

KMER_SIZE = 8
MAX_KMER_SIZE = 16
KMER_WSIZE = 1

MIN_COPY = 2
MAX_DIV = 0.25
MIN_PERIOD = 2
DEF_MIN_PERIOD = 30
MAX_PERIOD = 4294967295  # UINT32_MAX
DEF_MAX_PERIOD = 10000
DEF_MAX_PERIOD_STR = "10K"
DEF_MIN_LEN = 30
DEF_MIN_COV = 0.0

MATCH = 2
MISMATCH = 4
GAP_OPEN1 = 4
GAP_EXT1 = 2
GAP_OPEN2 = 24
GAP_EXT2 = 1

FASTA_FMT = 1
TAB_FMT = 2
FASTQ_FMT = 3
TAB_QUAL_FMT = 4

ADA_MATCH_RAT = 0.8


@dataclasses.dataclass
class Params:
    """Pipeline parameters (reference src/tidehunter.h:47-61)."""

    # seeding
    k: int = KMER_SIZE
    w: int = KMER_WSIZE
    hpc: bool = False
    # tandem repeat criteria
    min_copy: int = MIN_COPY
    max_div: float = MAX_DIV
    min_p: int = DEF_MIN_PERIOD
    max_p: int = DEF_MAX_PERIOD
    # consensus coverage filter (-r, dual typed: reference src/main.c:492-495)
    min_cov: int = 0
    min_frac: float = 0.0
    # POA scoring (convex / dual-affine)
    match: int = MATCH
    mismatch: int = MISMATCH
    gap_open1: int = GAP_OPEN1
    gap_open2: int = GAP_OPEN2
    gap_ext1: int = GAP_EXT1
    gap_ext2: int = GAP_EXT2
    # adapters
    ada_match_rat: float = ADA_MATCH_RAT
    five_fn: Optional[str] = None
    three_fn: Optional[str] = None
    five_seq: Optional[str] = None   # loaded sense-strand 5' adapter
    five_rc_seq: Optional[str] = None
    three_seq: Optional[str] = None  # loaded anti-sense-strand 3' adapter
    three_rc_seq: Optional[str] = None
    # output
    out_fmt: int = FASTA_FMT
    min_len: int = DEF_MIN_LEN
    only_unit: bool = False
    only_longest: bool = False
    only_full_length: bool = False
    single_copy: bool = False
    cons_out: Optional[IO[str]] = None
    # host threading (reference parity flag; the device path batches)
    n_thread: int = THREAD_N
    # consensus refinement rounds beyond the reference's single sequential
    # POA pass (realign all units to the frozen final profile); 0 = parity
    polish: int = 0
    # --- device path (no reference equivalent) ---
    chunk_read_n: int = CHUNK_READ_N
    # alignment length buckets for the plain-XLA path (cpu engine), where
    # DP cost is LQ*LT and a bucket spill pays the full ratio; the GPU
    # kernels round each up to a power of two.  The largest bucket is the
    # device cap: longer alignments run on the host (counted).
    aln_bucket_sizes: tuple = (128, 256, 384, 512, 640, 768, 1024, 1280,
                               1536, 2048, 3072, 4096, 6144, 8192)

    @property
    def five_len(self) -> int:
        return len(self.five_seq) if self.five_seq else 0

    @property
    def three_len(self) -> int:
        return len(self.three_seq) if self.three_seq else 0

    def out_stream(self) -> IO[str]:
        return self.cons_out if self.cons_out is not None else sys.stdout


def parse_num(s: str) -> int:
    """Parse a number with optional K/M/G suffix (reference src/main.c:54-63)."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "GgMmKk":
        mult = {"g": 1e9, "m": 1e6, "k": 1e3}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)
