"""Library API (tidehunter_tpu.api): Detector/detect parity with the CLI
pipeline — same stages, importable instead of exec'd."""

import io

import numpy as np
import pytest

import tidehunter_tpu
from tidehunter_tpu.api import Detector, detect
from tidehunter_tpu.pipeline.core import tidehunter_core
from tidehunter_tpu.params import Params


def _synth(rng, unit_len=50, copies=6, err=0.05, flank=30):
    bases = "ACGT"
    unit = [bases[i] for i in rng.integers(0, 4, unit_len)]
    parts = ["".join(bases[i] for i in rng.integers(0, 4, flank))]
    for _ in range(copies):
        out = []
        for c in unit:
            r = rng.random()
            if r < err / 3:
                continue
            if r < 2 * err / 3:
                out.append(bases[rng.integers(0, 4)])
            out.append(c)
        parts.append("".join(out))
    parts.append("".join(bases[i] for i in rng.integers(0, 4, flank)))
    return "".join(parts)


def test_detect_matches_core_oracle():
    rng = np.random.default_rng(7)
    seqs = [_synth(rng) for _ in range(4)]
    got = detect(seqs)
    assert len(got) == 4
    for seq, res in zip(seqs, got):
        oracle = tidehunter_core(seq, Params())
        assert [(r.seq, r.start, r.end, r.copy_num, r.ave_match)
                for r in res.records] == \
               [(r.seq, r.start, r.end, r.copy_num, r.ave_match)
                for r in oracle.records]
    # a 6-copy clean repeat must actually be found
    assert any(res.records for res in got)


def test_detect_engine_path_matches_host():
    rng = np.random.default_rng(11)
    seqs = [_synth(rng) for _ in range(6)]
    host = detect(seqs)
    with Detector(device="cpu") as det:
        dev = det.detect(seqs)
    key = lambda res: [(r.seq, r.start, r.end, round(r.copy_num, 3))
                       for r in res.records]
    assert [key(r) for r in dev] == [key(r) for r in host]


def test_detect_input_kinds_and_params():
    rng = np.random.default_rng(3)
    s = _synth(rng)
    from tidehunter_tpu.io.fastx import FastxRecord

    r_str, r_tup, r_rec = detect(
        [s, ("named", s), FastxRecord(name="rec", comment="", seq=s)],
        min_p=10,
    )
    assert [x.seq for x in r_str.records] == [x.seq for x in r_tup.records]
    assert [x.seq for x in r_str.records] == [x.seq for x in r_rec.records]
    with pytest.raises(TypeError, match="unknown parameter"):
        detect([s], not_a_param=1)
    with pytest.raises(ValueError, match="device"):
        Detector(device="npu")


def test_run_file_matches_cli_serialization(tmp_path):
    rng = np.random.default_rng(5)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(f">r{i}\n{_synth(rng)}\n" for i in range(3)))
    out = io.StringIO()
    det = Detector(out_fmt=2)
    m = det.run_file(str(fa), out=out)
    assert m.reads == 3
    lines = [l for l in out.getvalue().splitlines() if l]
    assert m.cons_records == len(lines)
    for l in lines:
        assert len(l.split("\t")) == 11


def test_package_level_exports():
    assert tidehunter_tpu.Detector is Detector
    assert tidehunter_tpu.Params is Params
    assert callable(tidehunter_tpu.detect)
