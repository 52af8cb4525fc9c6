"""Production multi-device path on the virtual 8-device CPU mesh.

The REAL engine kernels — the Pallas wavefront (ops/wavefront.py) and
device-MSA (ops/msa_device.py) — run through the Pallas interpreter
(interpret=True), sharded over a 1-D 'dp' mesh with jax.shard_map exactly
as on the cards, and must produce records bit-identical to the
single-device host-oracle pipeline (the reference's pthread fan-out role,
reference src/main.c:273-291, per SURVEY §5.8).
"""

import numpy as np
import pytest

import jax

from tidehunter_tpu.tools.synth import synth_read


@pytest.fixture()
def interpret_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tidehunter_tpu.parallel import mesh as PM

    m = PM.make_mesh(8)
    yield m
    PM.set_active_mesh(None)


def _records_key(res):
    return [
        (c.seq, c.qual, c.start, c.end, round(c.copy_num, 6),
         round(c.ave_match, 6), c.full_length, tuple(c.sub_pos))
        for c in res.records
    ]


@pytest.mark.parametrize("waves", ["1", "2"])
def test_engine_mesh_matches_oracle_synthetic(interpret_mesh, monkeypatch,
                                              waves):
    # waves=2 exercises the opt-in wave-split consensus drive (engine
    # TH_DRIVE_WAVES — concurrent _drive threads sharing the device)
    # through the full production mesh path; default stays 1
    from tidehunter_tpu.engine import Engine
    from tidehunter_tpu.io.fastx import FastxRecord
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline.core import tidehunter_core

    monkeypatch.setenv("TH_DRIVE_WAVES", waves)
    rng = np.random.default_rng(23)
    reads = [
        FastxRecord(
            name=f"m{i}", comment="",
            seq=synth_read(rng, unit_len=55, copies=4, err=0.06,
                               flank=25),
        )
        for i in range(10)
    ]
    mtp = Params()
    engine = Engine(mtp, platform="gpu", mesh=interpret_mesh,
                    interpret=True)
    assert engine.aligner.kernels
    results = engine(reads, mtp)
    for rec, res in zip(reads, results):
        want = tidehunter_core(rec.seq, mtp)
        assert _records_key(res) == _records_key(want), rec.name


def test_engine_mesh_matches_oracle_test_data(interpret_mesh, test_data):
    from tidehunter_tpu.engine import Engine
    from tidehunter_tpu.io.fastx import read_fastx
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline.core import tidehunter_core

    reads = list(read_fastx(str(test_data / "test_50x4.fa")))
    mtp = Params()
    engine = Engine(mtp, platform="gpu", mesh=interpret_mesh,
                    interpret=True)
    results = engine(reads, mtp)
    for rec, res in zip(reads, results):
        want = tidehunter_core(rec.seq, mtp)
        assert _records_key(res) == _records_key(want)
    # and the golden README record survives the mesh path end-to-end
    assert results[0].records[0].seq == (
        "CGATCGATCGGCATGCATGCATGCTAGTCGATGCATCGGGATCAGCTAGT"
    )


def test_mesh_vs_single_device_engine(interpret_mesh):
    """Mesh engine == single-device engine (same interpret kernels),
    record for record."""
    from tidehunter_tpu.engine import Engine
    from tidehunter_tpu.io.fastx import FastxRecord
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.parallel.mesh import set_active_mesh

    rng = np.random.default_rng(5)
    reads = [
        FastxRecord(
            name=f"s{i}", comment="",
            seq=synth_read(rng, unit_len=48, copies=5, err=0.08,
                               flank=40),
        )
        for i in range(6)
    ]
    mtp = Params()
    meshed = Engine(mtp, platform="gpu", mesh=interpret_mesh,
                    interpret=True)(reads, mtp)
    set_active_mesh(None)
    single = Engine(mtp, platform="gpu", mesh=None,
                    interpret=True)(reads, mtp)
    for a, b in zip(meshed, single):
        assert _records_key(a) == _records_key(b)
