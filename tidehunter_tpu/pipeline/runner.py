"""Chunked streaming runner.

Mirror of the reference driver loop (mini_tandem, reference
src/main.c:375-436): read chunks of up to `chunk_read_n` reads, process, and
serialize each chunk in input order. Adapter sequences are loaded once with
their reverse complements (main.c:389-394).

Adds what the reference lacks (SURVEY.md §5.3-5.4): a per-chunk progress
cursor written next to the output so interrupted runs resume at the first
unprocessed chunk, plus structured per-stage metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os

import time
from typing import IO, Iterator, List, Optional

from ..io.codec import revcomp_str
from ..io.fastx import FastxRecord, read_fastx, read_first_seq
from ..io.output import write_read_output
from ..params import Params
from ..utils.log import log
from .core import tidehunter_core


@dataclasses.dataclass
class RunMetrics:
    reads: int = 0
    chunks: int = 0
    cons_records: int = 0
    wall_s: float = 0.0

    def reads_per_s(self) -> float:
        return self.reads / self.wall_s if self.wall_s > 0 else 0.0


def load_adapters(mtp: Params) -> None:
    """Load 5'/3' adapter files and their revcomps (main.c:389-394)."""
    if mtp.five_fn is not None and mtp.three_fn is not None:
        mtp.five_seq = read_first_seq(mtp.five_fn)
        mtp.five_rc_seq = revcomp_str(mtp.five_seq)
        mtp.three_seq = read_first_seq(mtp.three_fn)
        mtp.three_rc_seq = revcomp_str(mtp.three_seq)


def _chunks(
    records: Iterator[FastxRecord], n: int
) -> Iterator[List[FastxRecord]]:
    buf: List[FastxRecord] = []
    for rec in records:
        buf.append(rec)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


def run(
    read_fn: str,
    mtp: Params,
    out: Optional[IO[str]] = None,
    resume_cursor: Optional[str] = None,
    process_chunk=None,
    shard: Optional[tuple] = None,
) -> RunMetrics:
    """Stream the input and emit results chunk by chunk, in input order.

    `process_chunk(chunk, mtp) -> list[TandemResult]` defaults to the
    sequential host oracle; the device engine injects its batched version.

    `shard=(i, n)` makes this process consume reads i, i+n, i+2n, ... —
    the multi-host data-parallel input sharding (SURVEY.md §5.8): each
    host of a pod slice runs its own shard and writes its own output
    file; ordering is preserved within each shard."""
    t0 = time.perf_counter()
    load_adapters(mtp)
    out = out if out is not None else mtp.out_stream()
    metrics = RunMetrics()

    skip_chunks = 0
    if resume_cursor and os.path.exists(resume_cursor):
        with open(resume_cursor) as f:
            state = json.load(f)
        skip_chunks = state.get("chunks_done", 0)
        log(f"resuming after {skip_chunks} completed chunks")

    if process_chunk is None:
        def process_chunk(chunk, mtp):
            return [tidehunter_core(rec.seq, mtp) for rec in chunk]

    def _emit(chunk_i, chunk, results):
        for rec, result in zip(chunk, results):
            write_read_output(out, rec.name, rec.seq, result, mtp)
            metrics.cons_records += len(result.records)
        metrics.reads += len(chunk)
        metrics.chunks += 1
        out.flush()
        if resume_cursor:
            tmp = resume_cursor + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"chunks_done": chunk_i + 1, "reads": metrics.reads}, f)
            os.replace(tmp, resume_cursor)

    records = read_fastx(read_fn)
    if shard is not None:
        si, sn = shard
        records = (
            rec for i, rec in enumerate(records) if i % sn == si
        )
    chunks = (
        (ci, ch)
        for ci, ch in enumerate(_chunks(records, mtp.chunk_read_n))
        if ci >= skip_chunks
    )

    if hasattr(process_chunk, "prepare_chunk"):
        # pipelined: prepare (host seed/chain) of chunk N+1 runs in a
        # background thread while finish (device rounds) of chunk N runs
        # here; output order stays input order because chunks are emitted
        # strictly in sequence.
        from concurrent.futures import ThreadPoolExecutor

        eng = process_chunk
        with ThreadPoolExecutor(max_workers=1) as prefetch:
            pending = None  # (chunk_i, chunk, future-of-prepared)
            for chunk_i, chunk in chunks:
                fut = prefetch.submit(eng.prepare_chunk, chunk, mtp)
                if pending is not None:
                    pi, pchunk, pfut = pending
                    _emit(pi, pchunk, eng.finish_chunk(pfut.result(), mtp))
                pending = (chunk_i, chunk, fut)
            if pending is not None:
                pi, pchunk, pfut = pending
                _emit(pi, pchunk, eng.finish_chunk(pfut.result(), mtp))
    else:
        for chunk_i, chunk in chunks:
            _emit(chunk_i, chunk, process_chunk(chunk, mtp))

    metrics.wall_s = time.perf_counter() - t0
    return metrics
