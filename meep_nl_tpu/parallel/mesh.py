"""Spatial domain decomposition over a device mesh.

The reference's only distributed strategy is chunk decomposition of the Yee
grid with MPI halo exchange (structure.cpp:66-198 split_by_cost,
boundaries.cpp:347 connect_the_chunks, step.cpp:226 step_boundaries).  Here a
shard IS a chunk: field arrays are sharded over a `jax.sharding.Mesh` along
the grid axes, and XLA's SPMD partitioner inserts the width-1 halo exchanges
(collective-permutes between devices) for the shifted-slice stencils — the analog of
the precomputed comms sequence, scheduled by XLA's latency-hiding scheduler
instead of MPI_Waitsome callbacks.

This module provides:
  * make_mesh        - build a 1/2/3-d device mesh for the grid
  * state_shardings  - NamedSharding pytree for a sim state
  * sharded_run      - jit-compiled scan of the step with sharding
                       constraints applied to the carried fields
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..stepper.plan import Plan
from ..stepper.step import make_step, build_xs


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              devices=None) -> Mesh:
    """Device mesh over which grid axes are sharded.

    Default: a 1-d mesh ('gx',) over all devices. For 2-d/3-d grids pass
    shape=(a, b[, c]) to decompose multiple axes (the analog of the
    reference's binary partition, structure.cpp:96)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        axis_names = tuple(f"g{'xyz'[i]}" for i in range(len(shape)))
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def grid_pspec(plan: Plan, mesh: Mesh) -> P:
    """PartitionSpec matching grid axes to mesh axes (leading grid axes)."""
    names = list(mesh.axis_names)
    ndim = plan.gv.ndim
    spec = []
    for ax in range(ndim):
        spec.append(names[ax] if ax < len(names) else None)
    return P(*spec)


def state_shardings(plan: Plan, mesh: Mesh, state: Dict[str, Any]):
    """Sharding pytree derived from the state leaves themselves: any array
    whose trailing dims equal the storage grid shape is sharded spatially
    (fields, PML/conductivity aux, polarizations incl. stacked multilevel
    (T,)+grid arrays); everything else — DFT accumulators (small monitor
    regions; the flux reduction is the analog of sum_to_all, dft.cpp:543),
    the step counter, RNG keys — is replicated.  Deriving from the leaves
    keeps BFAST (f_bfast), multilevel (f_w_prev), and noisy-media (rng)
    states shardable without a hard-coded key list."""
    spec = grid_pspec(plan, mesh)
    fs = NamedSharding(mesh, spec)
    rep = NamedSharding(mesh, P())
    ss = tuple(plan.storage_shape or plan.gv.shape)

    def assign(arr):
        shape = tuple(getattr(arr, "shape", ()))
        if shape == ss:
            return fs
        if len(shape) == len(ss) + 1 and shape[1:] == ss:
            return NamedSharding(mesh, P(None, *spec))
        return rep

    return jax.tree.map(assign, state)


def shard_state(plan: Plan, mesh: Mesh, state: Dict[str, Any]) -> Dict[str, Any]:
    sh = state_shardings(plan, mesh, state)
    return jax.tree.map(jax.device_put, state, sh)


def coef_shardings(plan: Plan, mesh: Mesh):
    """Shard full-shape coefficient arrays (and per-axis PML vectors)
    spatially; replicate the small ones (source tables, monitor weights)."""
    fs_spec = grid_pspec(plan, mesh)
    rep = NamedSharding(mesh, P())
    ss = plan.storage_shape or plan.gv.shape
    names = list(fs_spec)

    def assign(arr):
        if getattr(arr, "ndim", 0) == len(ss):
            spec = [names[ax] if arr.shape[ax] == ss[ax] else None
                    for ax in range(len(ss))]
            if any(s is not None for s in spec):
                return NamedSharding(mesh, P(*spec))
        return rep

    return {k: assign(v) for k, v in plan.coefs.items()}


def sharded_run_fn(plan: Plan, mesh: Mesh, nsteps: int):
    """jit-compiled (state, xs, coefs) -> state scanning `nsteps` steps with
    spatial sharding constraints pinned on the carry.  Cached on the plan
    per (mesh, nsteps), so repeated runs reuse one executable."""
    cache = getattr(plan, "_sharded_run_cache", None)
    if cache is None:
        cache = plan._sharded_run_cache = {}
    fn = cache.get((mesh, nsteps))
    if fn is not None:
        return fn
    step = make_step(plan)

    def runner(state, xs, C):
        sh = state_shardings(plan, mesh, state)
        state = jax.lax.with_sharding_constraint(state, sh)

        def body(carry, x):
            return step(carry, x, C), None

        state, _ = jax.lax.scan(body, state, xs, length=nsteps)
        return state

    fn = cache[(mesh, nsteps)] = jax.jit(runner)
    return fn


def sharded_run(plan: Plan, mesh: Mesh, state: Dict[str, Any], nsteps: int,
                t0: Optional[int] = None) -> Dict[str, Any]:
    """Advance `state` by nsteps with fields and coefficients sharded over
    `mesh` (GSPMD: XLA partitions the jnp step and inserts the halo
    exchanges).  Pass `t0` to skip the device read of state['t'], as
    stepper.step.run does."""
    if t0 is None:
        t0 = int(jax.device_get(state["t"]))
    xs = build_xs(plan, nsteps, t0)
    state = shard_state(plan, mesh, state)
    csh = coef_shardings(plan, mesh)
    C = {k: jax.device_put(v, csh[k]) for k, v in plan.coefs.items()}
    return sharded_run_fn(plan, mesh, nsteps)(state, xs, C)
