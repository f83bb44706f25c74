"""Device-mesh construction and multi-host initialization.

Capabilities the reference lacks entirely (it is a single-`MTLDevice` app,
``AAPLRenderer.m:39``): a 1-D ``('seq',)`` mesh for block-range
(sequence-parallel) decode, a 2-D ``('data', 'seq')`` mesh for frame-batch x
block-range decode, and `jax.distributed` bring-up for multi-host jobs. The
devices of one host are joined all to all, so a mesh's shape follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"  # frames (batch) axis
SEQ_AXIS = "seq"  # block-range (sequence-parallel) axis


def make_mesh(n_devices: int | None = None, axis_name: str = SEQ_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(
    n_devices: int | None = None,
    data_parallel: int | None = None,
    axis_names: tuple[str, str] = (DATA_AXIS, SEQ_AXIS),
) -> Mesh:
    """2-D ``data x seq`` mesh: frames sharded over ``data``, block ranges
    over ``seq``. ``data_parallel`` defaults to the largest power-of-two
    divisor <= sqrt(n)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data_parallel is None:
        data_parallel = 1
        while data_parallel * 2 <= max(1, int(n**0.5)) and n % (data_parallel * 2) == 0:
            data_parallel *= 2
    if n % data_parallel:
        raise ValueError(f"data_parallel={data_parallel} does not divide {n} devices")
    grid = np.array(devices).reshape(data_parallel, n // data_parallel)
    return Mesh(grid, axis_names)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up `jax.distributed` for a multi-host job.

    Nothing in the environment supplies the arguments: pass the coordinator
    address, the process count and this process's rank
    (``initialize_distributed('localhost:1234', 2, rank)``).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info() -> tuple[int, int]:
    """(process_index, process_count) — (0, 1) when not distributed."""
    return jax.process_index(), jax.process_count()
