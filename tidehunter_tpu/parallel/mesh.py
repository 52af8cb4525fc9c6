"""Multi-card / multi-host scale-out: data parallelism over a device mesh.

The reference's entire scale-out story is a pthread pool over reads on one
host (reference src/main.c:273-291,396-426); reads are fully independent.
The device equivalent (SURVEY.md §5.8): a 1-D 'dp' mesh over all cards,
each host streaming its own input shard; padded read/alignment batches are
sharded over 'dp' and kernels run under jit(shard_map) with explicit
shardings (ops/wavefront.py, ops/msa_device.py consult the active-mesh
registry below).  There are no data-path collectives: input sharding is
round-robin over reads (pipeline/runner.py --shard, auto-derived from
jax.process_index/count after the CLI's --dist bootstrap below), each host
writes its own output shard, and tools/merge.py restores global input
order.
"""

from __future__ import annotations


from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("dp",))


# --- active mesh registry -------------------------------------------------
#
# The production kernels (ops/wavefront.py, ops/msa_device.py) consult this
# to (a) scale their batch shapes by the mesh size and (b) route
# their pallas calls through jax.shard_map over the 'dp' axis.  One mesh
# per process: the engine installs it at construction (make_engine).

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def active_mesh_n() -> int:
    return 1 if _ACTIVE_MESH is None else int(_ACTIVE_MESH.devices.size)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """jax.distributed bootstrap for multi-host runs; no-op when single."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
