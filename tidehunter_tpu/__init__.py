"""TideHunter-TPU: an accelerator-native tandem repeat detection and
consensus engine in JAX, running on NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of TideHunter
(yangao07/TideHunter v1.5.5): batched, padded, bucketed tensor pipelines
in JAX/XLA with Pallas-Triton kernels, data-parallel over device meshes,
with a host-side streaming runtime.

Layers (mirroring reference layer map, SURVEY.md §1):
  io/        - FASTA/FASTQ streaming, 2-bit codec, output serializers
  ops/       - compute kernels: seeding, chaining, affine-gap DP (ksw2
               equivalent), Myers edit distance (edlib equivalent), POA
               consensus (abPOA equivalent); each with a NumPy oracle and
               a JAX (XLA or Pallas-Triton) device path
  pipeline/  - per-read orchestration and the chunked streaming runner
  parallel/  - device mesh / sharding for multi-card, multi-host scale-out
  utils/     - logging, timers, metrics
"""

from .version import __version__


def __getattr__(name):
    # Lazy: importing the package must stay cheap (the CLI and tools
    # import submodules directly; the library API pulls in the pipeline).
    if name in ("Detector", "detect"):
        from . import api

        return getattr(api, name)
    if name == "Params":
        from .params import Params

        return Params
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", "Detector", "detect", "Params"]
