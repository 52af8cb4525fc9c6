"""One device vocabulary and no hidden fallback.

`--device gpu` (the default) needs JAX's GPU backend and fails loudly
without one; `cpu` runs the plain-XLA alignment path; `off` is the host
oracle.  The engine picks each stage's implementation once, from its
platform; the interpreter is chosen only by an explicit argument.
"""

import os

import numpy as np
import pytest

from tidehunter_tpu import cli
from tidehunter_tpu.engine import Engine, _rows, check_backend, make_engine
from tidehunter_tpu.params import Params


@pytest.fixture()
def reads_fa(tmp_path):
    from tidehunter_tpu.tools.synth import synth_read

    rng = np.random.default_rng(1)
    fa = tmp_path / "r.fa"
    fa.write_text("".join(
        f">r{i}\n{synth_read(rng, 120, 5, 0.05, 30)}\n" for i in range(3)))
    return fa


def test_gpu_device_without_a_gpu_exits_nonzero(reads_fa, capsys):
    rc = cli.main(["-f", "2", "--device", "gpu", str(reads_fa)])
    assert rc == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_default_device_is_gpu(reads_fa):
    parsed = cli.parse_args(["-f", "2", str(reads_fa)])
    assert parsed[2]["device"] == "gpu"
    assert cli.main(["-f", "2", str(reads_fa)]) == 1


@pytest.mark.parametrize("bad", ["tpu", "cuda", ""])
def test_device_values_validated(bad, reads_fa, capsys):
    assert cli.parse_args(["--device", bad, str(reads_fa)]) == 1
    assert "--device needs gpu|cpu|off" in capsys.readouterr().err


def test_cpu_and_off_give_the_same_records(reads_fa, tmp_path):
    outs = []
    for dev in ("cpu", "off"):
        out = tmp_path / f"{dev}.tab"
        assert cli.main(["-f", "2", "--device", dev, "-o", str(out),
                         str(reads_fa)]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0]


def test_stage_choice_from_platform():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        Engine(Params(), platform="gpu")
    with pytest.raises(ValueError, match="platform"):
        check_backend("tpu")
    cpu = Engine(Params(), platform="cpu")
    assert not cpu.kernels and not cpu.aligner.kernels
    gpu = Engine(Params(), platform="gpu", interpret=True)
    assert gpu.kernels and gpu.aligner.kernels and gpu.aligner.interpret
    # the kernels' lane counts are powers of two, so are their buckets;
    # the largest bucket (the counted host cap) is unchanged
    assert gpu.aligner.buckets == [128, 256, 512, 1024, 2048, 4096, 8192]
    assert cpu.aligner.buckets[-1] == 8192
    with pytest.raises(RuntimeError):
        make_engine(Params(), platform="gpu")


@pytest.mark.parametrize("n,cap,mesh_n,want", [
    (1, 2048, 1, 8), (9, 2048, 1, 32), (100, 2048, 1, 128),
    (5000, 2048, 1, 2048), (20, 8, 1, 8), (9, 2048, 4, 32),
    (33, 2048, 8, 64)])
def test_row_rungs(n, cap, mesh_n, want):
    assert _rows(n, cap, mesh_n) == want


def test_host_cap_counted():
    """Alignments past the largest bucket leave the device by design,
    and are counted."""
    from tidehunter_tpu.utils.metrics import METRICS

    eng = Engine(Params(), platform="cpu")
    rng = np.random.default_rng(2)
    big = rng.integers(0, 4, 8300).astype(np.uint8)
    METRICS.reset()
    groups, host = eng.aligner._grouped([(big, big), (big[:50], big[:60])])
    assert host == [0] and list(groups) == [(128, 128)]
    assert METRICS.snapshot()["host_cap_aln"] == 1


def test_native_library_key_tracks_flags(monkeypatch):
    from tidehunter_tpu import native

    a = native.lib_path()
    assert os.path.basename(a).startswith("libchainx-")
    assert ".native_build" in a
    monkeypatch.setenv("CC", "some-other-cc")
    assert native.lib_path() != a


def test_compile_cache_dir(monkeypatch):
    import jax

    from tidehunter_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    compile_cache.enable_compile_cache()          # JAX reads the variable
    assert jax.config.jax_compilation_cache_dir == before
    assert compile_cache.CACHE_DIR.endswith(".jax_cache")
    assert os.path.dirname(compile_cache.CACHE_DIR) == os.path.dirname(
        os.path.dirname(os.path.abspath(cli.__file__)))
