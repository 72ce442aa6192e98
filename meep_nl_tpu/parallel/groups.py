"""Process-group sweeps: run independent simulations on device subsets.

Analog of divide_parallel_processes / merge_subgroup_data (mympi.cpp:818,
python/tests/test_divide_mpi_processes.py): the reference splits
MPI_COMM_WORLD so embarrassingly-parallel parameter sweeps each get a group
of ranks.  Here the same role is filled by splitting the device list into
sub-meshes and running one simulation per sub-mesh; results merge on the
host.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import jax

from .mesh import make_mesh


def divide_parallel_devices(n_groups: int, devices=None) -> List:
    """Split the device list into n contiguous groups (the mesh analog of
    divide_parallel_processes)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_groups > n:
        raise ValueError(f"cannot make {n_groups} groups from {n} devices")
    per = n // n_groups
    return [devices[i * per:(i + 1) * per] for i in range(n_groups)]


def run_parameter_sweep(fn: Callable[[int, Any], Any],
                        params: Sequence[Any],
                        n_groups: Optional[int] = None) -> List[Any]:
    """Run fn(group_index, param) per parameter with each call pinned to its
    own device group via jax.default_device.

    fn typically builds a Simulation, runs it, and returns host data; the
    list of results is the merge_subgroup_data analog."""
    if n_groups is None:
        n_groups = min(len(params), len(jax.devices()))
    groups = divide_parallel_devices(n_groups)
    results = []
    for i, p in enumerate(params):
        dev = groups[i % n_groups][0]
        with jax.default_device(dev):
            results.append(fn(i % n_groups, p))
    return results


def merge_subgroup_data(results: Sequence[Any]) -> np.ndarray:
    """Stack per-group results (mympi.cpp merge_subgroup_data)."""
    return np.stack([np.asarray(r) for r in results])
