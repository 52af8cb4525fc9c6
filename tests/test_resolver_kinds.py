"""Engine._resolve_batch concurrency contract: a drive round mixing every
request kind resolves each kind on a thread pool (overlapped device
rounds); results must be positionally identical to the serialized path
(TH_SERIAL_KINDS=1) regardless of completion order.  Kind semantics per
the generator protocol in engine.py (reference roles: ksw2_align.c /
edlib_align.c / abpoa_cons.c adapters)."""

import time

import numpy as np
import pytest

from tidehunter_tpu.engine import Engine
from tidehunter_tpu.params import Params


class _FakeAligner:
    """Deterministic stand-in with staggered latencies so the pooled
    path genuinely interleaves completions."""

    use_wavefront = True

    def run_global(self, reqs):
        time.sleep(0.02)
        return [(len(q) + len(t), qle) for q, t, qle in reqs]

    def run_giden(self, pairs):
        time.sleep(0.01)
        return [len(q) * 1000 + len(t) for q, t in pairs]

    def run_ext(self, reqs):
        time.sleep(0.03)
        return [(len(q), len(t)) for q, t in reqs]


def _mk_reqs(rng):
    def s(n):
        return np.asarray(rng.integers(0, 4, n), np.uint8)

    return [
        ("global", s(30), s(40), 7),
        ("gx", [(s(10), s(12)), (s(11), s(13))], [(s(20), s(30))]),
        ("giden", s(25), s(26)),
        ("msa", [s(50), s(51), s(49)]),
        ("gidens", [(s(5), s(6)), (s(7), s(8)), (s(9), s(10))]),
        ("hws", [(s(14), s(80), 3), (s(15), s(90), 4)]),
        ("ext", s(33), s(44)),
        ("exts", [(s(21), s(22)), (s(23), s(24))]),
        ("global", s(60), s(70), 11),
        ("msa", [s(40), s(41)]),
    ]


@pytest.fixture()
def engine(monkeypatch):
    eng = Engine(Params(), platform="gpu", interpret=True)
    monkeypatch.setattr(eng, "aligner", _FakeAligner())
    monkeypatch.setattr(
        eng, "_resolve_msa",
        lambda regions: [sum(len(u) for u in units) for units in regions])
    import tidehunter_tpu.ops.myers_jax as mj

    monkeypatch.setattr(
        mj, "hw_batch",
        lambda qs, ts, ks: [(len(q), len(t), k)
                            for q, t, k in zip(qs, ts, ks)])
    yield eng
    eng.close()


def _norm(out):
    # numpy payloads -> plain tuples for ==
    def conv(x):
        if isinstance(x, (list, tuple)):
            return tuple(conv(v) for v in x)
        return x

    return [conv(o) for o in out]


def test_parallel_matches_serial(engine, monkeypatch):
    rng = np.random.default_rng(3)
    reqs = _mk_reqs(rng)
    par = _norm(engine._resolve_batch(list(reqs)))
    monkeypatch.setenv("TH_SERIAL_KINDS", "1")
    ser = _norm(engine._resolve_batch(list(reqs)))
    assert par == ser
    assert None not in par
    # spot-check positional mapping survived the pool's arbitrary
    # completion order
    assert par[0] == (70, 7)          # global: len sums + echoed qle
    assert par[6] == (33, 44)         # ext
    assert par[3] == 150              # msa: summed unit lengths


def test_single_kind_stays_serial(engine):
    # one-kind rounds skip the pool (len(work) <= 1): same answers
    rng = np.random.default_rng(4)
    reqs = [("giden", np.zeros(8, np.uint8), np.zeros(9, np.uint8))]
    assert engine._resolve_batch(reqs) == [8009]
