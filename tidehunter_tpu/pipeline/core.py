"""Per-read pipeline: seed -> chain -> partition -> consensus.

Orchestration mirror of the reference core (tidehunter_core, reference
src/tidehunter.c:23-60). This is the host-side oracle path; the device runner
(pipeline/runner.py) executes the same stages with batched device kernels
and falls back to these routines per read.
"""

from __future__ import annotations

import os
import sys



from ..io.codec import encode
from ..io.output import TandemResult
from ..params import Params
from ..ops.chaining import tandem_chain
from ..ops.partition import partition_positions
from ..ops.seeding import collect_tandem_repeat_hits
from .consensus import seqs_msa, single_copy_full_len_seq

# TH_DEBUG=1 dumps hits / chains / partition positions per read to stderr
# — the counterpart of the reference's `make debug=1` __DEBUG__ channels
# (reference src/tandem_hit.c:199-201, tandem_chain.c:374-390,
# partition.c:201-204), usable as a diff oracle against the reference
# harness (/tmp/refharness, see .claude/skills/verify/SKILL.md).
_DEBUG = os.environ.get("TH_DEBUG") == "1"


def tidehunter_core(read_seq: str, mtp: Params) -> TandemResult:
    """Process one read; returns its TandemResult (record accumulator)."""
    result = TandemResult()
    seq_len = len(read_seq)
    if seq_len < mtp.k:
        return result
    bseq = encode(read_seq)

    ends, periods = collect_tandem_repeat_hits(
        bseq, mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p
    )
    if _DEBUG:
        for e, p in zip(ends, periods):
            sys.stderr.write(f"hit\t{e}\t{p}\n")
    dp, chains = tandem_chain(ends, periods, mtp.k)
    if _DEBUG:
        for ci, ch in enumerate(chains):
            cells = " ".join(
                f"{dp.start[c]}-{dp.end[c]}" for c in ch.cells
            )
            sys.stderr.write(
                f"chain\t{ci}\tperiod={ch.est_period}\t"
                f"start={ch.est_start}\t{cells}\n"
            )
    for ch in chains:
        par_pos = partition_positions(
            bseq, seq_len, dp, ch, mtp.k, mtp.max_div
        )
        if _DEBUG:
            sys.stderr.write(
                "par\t" + ",".join(str(p) for p in par_pos) + "\n"
            )
        if len(par_pos) < mtp.min_copy + 1:
            continue  # not enough copies (tidehunter.c:42)
        seqs_msa(seq_len, bseq, par_pos, result, mtp)

    if (
        mtp.single_copy
        and mtp.only_full_length
        and mtp.five_seq is not None
        and mtp.three_seq is not None
    ):
        single_copy_full_len_seq(read_seq, result, mtp)
    return result
