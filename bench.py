"""Benchmark: Yee-cell updates per second through Simulation.run on a GPU.

The reference's own throughput metric is grid-point updates/sec
(tests/bench.cpp:28-54 `b.gridsteps/b.time`), here GCells/s = 1e9 Yee-cell
updates per second, timed on the path a user's `Simulation.run` takes (the
jnp step under `lax.scan`, compiled by XLA) and fenced with
`jax.block_until_ready`.

    python bench.py                 # every cell, each in a child process
    BENCH_CELL=vacuum python bench.py   # one cell, in this process

Cells: vacuum (3D uPML), monitored (vacuum + DFT flux plane), flagship
(eps=4 sphere, Lorentz pole, chi2 Newton, flux plane), periodic (x-periodic
k=0, uPML on y/z), bloch (oblique k_x, native complex fields), 2d (TM
dielectric disk, uPML).  BENCH_N sets the cells per axis (default 384 in 3D,
2048 in 2D), BENCH_STEPS the timed steps (default 200).

The parent never imports JAX: the cells run one after another in child
processes, so one JAX process holds the card at a time.  Each cell prints
one JSON record naming platform, device_kind and device count; a run that
finds no GPU fails.  The parent prints every record and then one merged
line.  The compile cache is JAX_COMPILATION_CACHE_DIR when set, else
<repo>/.jax_cache.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CELLS = ("vacuum", "monitored", "flagship", "periodic", "bloch", "2d")


def build(cell: str, n: int):
    """The Simulation of one benchmark cell at n cells per axis."""
    import meep_nl_tpu as mp
    from chip_smoke import flagship_sim
    if cell in ("vacuum", "monitored", "flagship"):
        sim, _ = flagship_sim((n,) * 3, material=cell == "flagship",
                              flux=cell != "vacuum")
        return sim
    res = 16.0
    src = mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.4),
                    component=mp.Ez, center=mp.Vector3())
    if cell == "2d":
        size = n / res
        disk = mp.Cylinder(radius=size / 6, material=mp.Medium(epsilon=12))
        return mp.Simulation(
            cell_size=mp.Vector3(size, size), resolution=res,
            geometry=[disk], sources=[src], boundary_layers=[mp.PML(1.0)])
    size = n / res
    kx = 0.23 / size if cell == "bloch" else 0.0
    return mp.Simulation(
        cell_size=mp.Vector3(size, size, size), resolution=res,
        sources=[src], k_point=mp.Vector3(kx, 0, 0),
        boundary_layers=[mp.PML(1.0, direction="y"),
                         mp.PML(1.0, direction="z")])


def run_cell(cell: str) -> dict:
    import numpy as np
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    n = int(os.environ.get("BENCH_N", "2048" if cell == "2d" else "384"))
    steps = int(os.environ.get("BENCH_STEPS", "200"))
    t = time.perf_counter()
    sim = build(cell, n)
    sim.init_sim()
    setup = time.perf_counter() - t
    until = steps * sim.dt
    t = time.perf_counter()
    sim.run(until=until)
    jax.block_until_ready(sim._state)
    first = time.perf_counter() - t
    best = np.inf
    for _ in range(2):
        t = time.perf_counter()
        sim.run(until=until)
        jax.block_until_ready(sim._state)
        best = min(best, time.perf_counter() - t)
    ncell = int(np.prod(sim._plan.gv.num))
    return {
        "metric": f"yee_cell_updates_{cell}_fp32",
        "value": ncell * steps / best / 1e9, "unit": "GCells/s",
        "cells": list(sim._plan.gv.num), "steps": steps,
        "setup_s": setup, "compile_s": first - best,
        "platform": devs[0].platform, "device_kind": devs[0].device_kind,
        "device_count": len(devs)}


def main() -> int:
    one = os.environ.get("BENCH_CELL")
    if one:
        print(json.dumps(run_cell(one)), flush=True)
        return 0
    timeout = float(os.environ.get("BENCH_TIMEOUT", "900"))
    merged, rc = {}, 0
    for cell in CELLS:
        try:
            out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                                 env=dict(os.environ, BENCH_CELL=cell),
                                 capture_output=True, text=True,
                                 timeout=timeout)
        except subprocess.TimeoutExpired:
            merged[cell] = {"error": f"timeout after {timeout:g} s"}
            rc = 1
            continue
        recs = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not recs:
            tail = (out.stderr or out.stdout).strip().splitlines()[-1:]
            merged[cell] = {"error": f"rc={out.returncode} {tail}"}
            rc = 1
        else:
            merged[cell] = json.loads(recs[-1])
        print(json.dumps({cell: merged[cell]}), flush=True)
    print(json.dumps({"metric": "yee_cell_updates_fp32", "unit": "GCells/s",
                      "cells": merged}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
