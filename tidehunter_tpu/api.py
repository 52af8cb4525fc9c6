"""Library API: programmatic tandem-repeat detection.

The reference is CLI-only (reference src/main.c:438); a framework should
also be importable. This module exposes the same pipeline the CLI drives
(pipeline/runner.py + engine.py) as plain Python calls:

    from tidehunter_tpu import Detector, detect

    # one-shot, host path — no JAX/device initialization
    results = detect(["ACGT" * 100], min_p=4)
    for rec in results[0].records:
        print(rec.seq, rec.copy_num, rec.ave_match)

    # reusable device engine (compiles kernels once, batches across calls)
    with Detector(device="gpu", k=8, w=1) as det:
        results = det.detect(seqs)
        det.run_file("reads.fq.gz", out=open("cons.fa", "w"))

Results are ``TandemResult`` objects (one per input read, input order),
each holding ``.records`` — a list of ``ConsRecord`` with the same fields
the CLI serializes (consensus seq/qual, start/end, copy_num, ave_match,
full_length, unit boundaries ``sub_pos``).
"""

from __future__ import annotations

import dataclasses
from typing import IO, Iterable, List, Optional, Union

from .io.fastx import FastxRecord
from .io.output import TandemResult
from .params import Params
from .pipeline import runner
from .pipeline.core import tidehunter_core

SeqLike = Union[str, FastxRecord, tuple]

_PARAM_FIELDS = {f.name for f in dataclasses.fields(Params)}


def _make_params(overrides: dict) -> Params:
    unknown = set(overrides) - _PARAM_FIELDS
    if unknown:
        raise TypeError(
            f"unknown parameter(s): {sorted(unknown)}; "
            f"valid names are the fields of tidehunter_tpu.params.Params"
        )
    return dataclasses.replace(Params(), **overrides)


def _as_record(i: int, s: SeqLike) -> FastxRecord:
    if isinstance(s, FastxRecord):
        return s
    if isinstance(s, tuple):
        name, seq = s
        return FastxRecord(name=str(name), comment="", seq=seq)
    return FastxRecord(name=f"read_{i}", comment="", seq=str(s))


class Detector:
    """Reusable detection pipeline with an optional device engine.

    ``device``: "off" (host oracle, no JAX), "cpu" (plain-XLA alignment
    on JAX's CPU backend), or "gpu" (the batched device engine via
    ``engine.make_engine``; needs a GPU backend; kernel compiles are paid
    on the first call and kept in the persistent compile cache). Engine
    construction is lazy, so building a Detector never touches a device.

    Keyword arguments are ``Params`` field overrides (k, w, hpc, min_copy,
    max_div, min_p, max_p, min_cov/min_frac, POA scores, five_fn/three_fn,
    out_fmt, min_len, only_* flags, single_copy, polish, ...); defaults
    match the reference CLI defaults (reference src/tidehunter.h:9-41).
    """

    def __init__(self, device: str = "off", mesh=None, **params):
        if device not in ("gpu", "cpu", "off"):
            raise ValueError("device must be 'gpu', 'cpu' or 'off'")
        self.params = _make_params(params)
        self.device = device
        self._mesh = mesh
        self._engine = None
        self._adapters_loaded = False

    # -- internals ---------------------------------------------------
    def _ensure_adapters(self) -> None:
        if not self._adapters_loaded:
            runner.load_adapters(self.params)
            self._adapters_loaded = True

    def _process_chunk(self):
        if self.device == "off":
            return None  # runner falls back to the sequential host oracle
        if self._engine is None:
            from .engine import make_engine
            from .utils.compile_cache import enable_compile_cache

            enable_compile_cache()
            self._engine = make_engine(
                self.params, platform=self.device, mesh=self._mesh
            )
        return self._engine

    # -- API ----------------------------------------------------------
    def detect(self, seqs: Iterable[SeqLike]) -> List[TandemResult]:
        """Detect tandem repeats in in-memory sequences.

        ``seqs``: strings, (name, seq) tuples, or FastxRecords. Returns
        one TandemResult per input, in input order.
        """
        self._ensure_adapters()
        records = [_as_record(i, s) for i, s in enumerate(seqs)]
        engine = self._process_chunk()
        mtp = self.params
        results: List[TandemResult] = []
        if engine is None:
            for rec in records:
                results.append(tidehunter_core(rec.seq, mtp))
            return results
        n = max(1, mtp.chunk_read_n)
        for i in range(0, len(records), n):
            results.extend(engine(records[i : i + n], mtp))
        return results

    def run_file(
        self,
        read_fn: str,
        out: Optional[IO[str]] = None,
        resume_cursor: Optional[str] = None,
        shard: Optional[tuple] = None,
    ) -> runner.RunMetrics:
        """Stream a FASTA/FASTQ[.gz] file and serialize records to ``out``
        (default stdout) in the configured ``out_fmt`` — the CLI's engine
        room as a call. Returns RunMetrics (reads, chunks, cons_records)."""
        return runner.run(
            read_fn,
            self.params,
            out=out,
            resume_cursor=resume_cursor,
            process_chunk=self._process_chunk(),
            shard=shard,
        )

    def close(self) -> None:
        if self._engine is not None:
            self._engine.close()
            self._engine = None

    def __enter__(self) -> "Detector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def detect(seqs: Iterable[SeqLike], device: str = "off", **params) -> List[TandemResult]:
    """One-shot convenience wrapper around Detector.detect."""
    with Detector(device=device, **params) as det:
        return det.detect(seqs)
