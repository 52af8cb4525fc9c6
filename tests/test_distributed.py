"""Real 2-process jax.distributed execution (CPU backend).

Two CLI processes bootstrap one jax.distributed world via --dist, derive
their input shards automatically from jax.process_index/count, write
per-shard outputs, and the merge tool restores a byte-identical copy of
the unsharded run — the multi-host analogue of the reference's pthread
fan-out (reference src/main.c:273-291,396-426; SURVEY.md §5.8).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env():
    """Env for subprocess CLIs: plain CPU jax, one device each."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    return env


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def many_reads_fa(tmp_path_factory):
    import numpy as np

    rng = np.random.default_rng(5)
    fa = tmp_path_factory.mktemp("dist") / "in.fa"
    lines = []
    for i in range(8):
        unit = "".join("ACGT"[b] for b in rng.integers(0, 4, 60))
        read = "TTGACGTGCA" + unit * (3 + i % 3) + "GGTCAGTCAA"
        lines.append(f">r{i}\n{read}")
    fa.write_text("\n".join(lines) + "\n")
    return fa


def _run_cli(args, timeout=180):
    p = subprocess.Popen(
        [sys.executable, "-m", "tidehunter_tpu.cli", *args],
        cwd=REPO, env=_child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    return p


def test_two_process_distributed_matches_unsharded(many_reads_fa, tmp_path):
    base = ["--device", "off", "-f", "2"]
    # unsharded reference run
    ref = tmp_path / "all.tab"
    p = _run_cli([*base, "-o", str(ref), str(many_reads_fa)])
    out, err = p.communicate(timeout=180)
    assert p.returncode == 0, err.decode()

    # two processes, one jax.distributed world
    port = _free_port()
    sharded = tmp_path / "sharded.tab"
    procs = [
        _run_cli([*base, "--dist", f"127.0.0.1:{port}/2/{i}",
                  "-o", str(sharded), str(many_reads_fa)])
        for i in range(2)
    ]
    errs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, errs):
        assert p.returncode == 0, err.decode()
    # each process must have auto-derived its shard from the world
    for i, (_, err) in enumerate(errs):
        assert f"auto input shard {i}/2".encode() in err, err.decode()

    shard_files = [f"{sharded}.shard{i}-of-2" for i in range(2)]
    for f in shard_files:
        assert os.path.exists(f)

    merged = subprocess.run(
        [sys.executable, "-m", "tidehunter_tpu.tools.merge",
         "-i", str(many_reads_fa), "-f", "2", *shard_files],
        cwd=REPO, env=_child_env(), capture_output=True, timeout=60,
    )
    assert merged.returncode == 0, merged.stderr.decode()
    assert merged.stdout.decode() == ref.read_text()
    assert merged.stdout.decode().strip(), "empty merged output"


def test_dist_flag_validation():
    from tidehunter_tpu.cli import _parse_dist

    assert _parse_dist("10.0.0.1:8476/4/0") == ("10.0.0.1:8476", 4, 0)
    assert _parse_dist("host:1/2/1") == ("host:1", 2, 1)
    assert _parse_dist("nonsense") is None
    assert _parse_dist("h:1/2/2") is None       # id out of range
    assert _parse_dist("/2/0") is None          # empty coordinator
