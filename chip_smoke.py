#!/usr/bin/env python3
"""Smoke test of the FDTD main path on NVIDIA GPUs.

    python chip_smoke.py                # phases a-e on one GPU
    python chip_smoke.py --four-cards   # only the sharded path, on 4 GPUs

One card:
  a  device: jax.devices() and nvidia-smi's card name and power limit
  b  exactness: the flagship (eps=4 sphere with a Lorentz pole and chi2 on
     the Newton path, uPML on every side, Gaussian Ez source, DFT flux
     plane) at 128^3 for 200 steps on the GPU and on the CPU backend; every
     E/H component (L2 error over the largest component's norm) and the
     flux spectrum (relative L2) agree within 1e-4
  c  full width: the flagship and vacuum-uPML at 384^3 through
     Simulation.run: setup, compile, steady GCells/s, peak device memory,
     bytes/cell/step and its share of the card's HBM bandwidth, beside the
     rate a 4 GB device-to-device copy reaches
  d  2D probe path: Meep's examples/ring.py with Harminv; the GPU finds the
     CPU run's modes within 1e-5 relative frequency
  e  adjoint: one jax.grad gradient through the time loop and one two-run
     ("pair") gradient at the size of examples/mode_converter_opt.py, each
     within 1e-3 (relative L2) of the same method on the CPU
Four cards: the flagship at 768x384x384 sharded over a 1-D x mesh
(parallel.mesh.sharded_run) against the same plan on one card.

Every number is printed with the card's name and power limit.  The last
stdout line is {"ok": true, "device": {...}}; without a GPU, or when a
phase fails, the script exits non-zero and prints no such line.  The
compile cache is JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Published HBM bandwidth per device_kind, bytes/s (NVIDIA H100 data
#: sheet: SXM5 3.35 TB/s, PCIe 2.0 TB/s).  A card missing here is an error.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

CARD = "card not read"       # "<name>, <power limit>" once phase a ran


def say(msg: str) -> None:
    """Print a measurement line labelled with the card it was taken on."""
    print(f"{msg}  [{CARD}]", flush=True)


# --------------------------------------------------------------------- a
def gpu_devices():
    """jax.devices() when they are GPUs; exits non-zero otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r} devices only")
    return devs


def parse_smi(line: str):
    """(name, watts) from one `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` line; watts is None when the card reports none."""
    name, _, power = line.rpartition(",")
    try:
        watts = float(power.split()[0])
    except (IndexError, ValueError):
        watts = None
    return name.strip(), watts


def nvidia_smi() -> list:
    """The card lines of nvidia-smi, read in a child that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_a(devs) -> None:
    global CARD
    print(f"jax.devices(): {devs}")
    lines = nvidia_smi()
    for ln in lines:
        print(ln)
    CARD = lines[0]
    print(f"cards: {[parse_smi(ln) for ln in lines]}")


# ------------------------------------------------------------ shared parts
def flagship_sim(cells, res: float = 16.0, material: bool = True,
                 flux: bool = True):
    """The flagship Simulation (bench.py's monitored nl cell): an eps=4
    sphere with a Lorentz pole and chi2 on the Newton path, uPML on every
    side, a Gaussian Ez source and a 3-frequency DFT flux plane.  With
    material=False and flux=False it is the vacuum-uPML cell."""
    import meep_nl_tpu as mp
    size = [n / res for n in cells]
    geometry = []
    if material:
        med = mp.Medium(epsilon=4.0, chi2=0.05, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=2.0, gamma=0.05, sigma=0.2)])
        geometry = [mp.Sphere(radius=min(size) / 4.0, material=med)]
    x_src = -size[0] * (0.35 if material else 0.25)
    sim = mp.Simulation(
        cell_size=mp.Vector3(*size), resolution=res, geometry=geometry,
        eps_averaging=False,
        sources=[mp.Source(mp.GaussianSource(frequency=1.0, fwidth=0.4),
                           component=mp.Ez, center=mp.Vector3(x_src, 0, 0))],
        boundary_layers=[mp.PML(0.5)])
    fl = None
    if flux:
        fl = sim.add_flux(1.0, 0.2, 3, mp.FluxRegion(
            center=mp.Vector3(-x_src, 0, 0),
            size=mp.Vector3(0, size[1] * 0.4, size[2] * 0.4)))
    return sim, fl


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| (0 when both vanish)."""
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    den = np.linalg.norm(ref)
    num = np.linalg.norm(got - ref)
    return float(num / den) if den > 0 else float(num)


def compare_fields(got: dict, ref: dict, tol: float) -> dict:
    """L2 error per component over the L2 norm of the largest reference
    component (roundoff in a weak component is set by the dominant field);
    raises AssertionError naming every component above `tol` (or not
    finite)."""
    scale = max(np.linalg.norm(np.asarray(v)) for v in ref.values())
    errs = {k: float(rel_l2(got[k], ref[k])
                     * np.linalg.norm(np.asarray(ref[k])) / scale)
            for k in ref}
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"above {tol:g}: {bad}")
    return errs


def bytes_per_cell_step(plan, state) -> float:
    """Bytes one step moves per Yee cell if every state array is read and
    written once and every coefficient array is read once."""
    import jax
    ncell = int(np.prod(plan.gv.num))
    st = sum(2 * int(a.nbytes) for a in jax.tree.leaves(state))
    co = sum(int(a.nbytes) for a in plan.coefs.values())
    return (st + co) / ncell


def hbm_peak(kind: str) -> float:
    if kind not in HBM_PEAK:
        raise KeyError(f"no published HBM bandwidth for {kind!r}; add it "
                       "to HBM_PEAK with its source")
    return HBM_PEAK[kind]


def _fields(sim) -> dict:
    return {k: np.asarray(v) for k, v in sim._state["f"].items()
            if k[0] in "eh"}


def _rasterizer(sim) -> str:
    """Which rasterizer scene.build_material took for this Simulation."""
    from meep_nl_tpu import native
    if (sim.eps_averaging and sim.geometry
            and native.serialize_objects(sim.geometry) is not None
            and native.get_lib() is not None):
        return "native C++"
    return "NumPy"


# --------------------------------------------------------------------- b
def phase_b(dev, cpu, cells: int = 128, steps: int = 200,
            tol: float = 1e-4) -> dict:
    """The flagship on `dev` and on the CPU device `cpu`, compared."""
    import jax
    out = {}
    for name, d in (("dev", dev), ("cpu", cpu)):
        with jax.default_device(d):
            sim, fl = flagship_sim((cells,) * 3)
            sim.run(until=steps * sim.dt)
            out[name] = (_fields(sim), np.asarray(sim.get_fluxes(fl)))
        del sim
    errs = compare_fields(out["dev"][0], out["cpu"][0], tol)
    errs["flux"] = rel_l2(out["dev"][1], out["cpu"][1])
    say(f"b: {cells}^3 flagship, {steps} steps, {dev.platform} vs cpu "
        f"relative L2: " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in sorted(errs.items())))
    if not errs["flux"] <= tol:
        raise AssertionError(f"flux spectrum off by {errs['flux']:.3e}")
    return errs


# --------------------------------------------------------------------- c
def copy_rate(dev, nbytes: int = 4 << 30) -> float:
    """Bytes/s (read + write) of a large elementwise device-to-device
    copy on `dev`."""
    import jax
    import jax.numpy as jnp
    x = jax.device_put(jnp.ones(nbytes // 4, jnp.float32), dev)
    f = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(f(x))
    best = np.inf
    for _ in range(5):
        t = time.perf_counter()
        jax.block_until_ready(f(x))
        best = min(best, time.perf_counter() - t)
    del x
    return 2 * nbytes / best


def time_cell(dev, name: str, cells: int, material: bool, flux: bool,
              steps: int = 200, repeats: int = 2) -> dict:
    """Setup, compile and steady rate of one cell through Simulation.run."""
    import jax
    t = time.perf_counter()
    sim, _ = flagship_sim((cells,) * 3, material=material, flux=flux)
    sim.init_sim()
    setup = time.perf_counter() - t
    dt = sim.dt
    t = time.perf_counter()
    sim.run(until=steps * dt)
    jax.block_until_ready(sim._state)
    first = time.perf_counter() - t
    best = np.inf
    for _ in range(repeats):
        t = time.perf_counter()
        sim.run(until=steps * dt)
        jax.block_until_ready(sim._state)
        best = min(best, time.perf_counter() - t)
    for k, v in _fields(sim).items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{name}: {k} not finite")
    ncell = int(np.prod(sim._plan.gv.num))
    rec = dict(
        cell=name, cells=list(sim._plan.gv.num), steps=steps,
        setup_s=setup, rasterizer=_rasterizer(sim),
        compile_s=first - best, step_s=best / steps,
        gcells_per_s=ncell * steps / best / 1e9,
        peak_bytes=(dev.memory_stats() or {}).get("peak_bytes_in_use"),
        bytes_per_cell_step=bytes_per_cell_step(sim._plan, sim._state))
    rec["hbm_bytes_per_s"] = rec["bytes_per_cell_step"] * ncell * steps / best
    del sim
    gc.collect()
    return rec


def phase_c(dev, cells: int = 384) -> list:
    rate = copy_rate(dev)
    say(f"c: 4 GB device copy {rate / 1e9:.1f} GB/s (read+write), "
        f"{rate / hbm_peak(dev.device_kind):.3f} of the published "
        f"{hbm_peak(dev.device_kind) / 1e12:.2f} TB/s")
    recs = []
    # vacuum first: peak_bytes_in_use only grows, so the smaller cell
    # must be read before the larger one allocates
    for name, mat in (("vacuum-uPML", False), ("flagship", True)):
        rec = time_cell(dev, name, cells, material=mat, flux=mat)
        rec["hbm_share"] = rec["hbm_bytes_per_s"] / hbm_peak(dev.device_kind)
        recs.append(rec)
        say(f"c: {name} {cells}^3: setup {rec['setup_s']:.2f} s "
            f"({rec['rasterizer']} rasterizer), compile "
            f"{rec['compile_s']:.2f} s, {rec['step_s'] * 1e3:.3f} ms/step, "
            f"{rec['gcells_per_s']:.3f} GCells/s, peak "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB, "
            f"{rec['bytes_per_cell_step']:.1f} B/cell/step -> "
            f"{rec['hbm_bytes_per_s'] / 1e12:.3f} TB/s = "
            f"{rec['hbm_share']:.3f} of published HBM, "
            f"{rec['hbm_bytes_per_s'] / rate:.3f} of the copy rate")
        print(json.dumps(rec))
    return recs


# --------------------------------------------------------------------- d
def ring_modes(dev, resolution: float = 10.0, after: float = 300.0):
    """Meep's examples/ring.py: Harminv modes of a 2D ring resonator."""
    import jax
    import meep_nl_tpu as mp
    with jax.default_device(dev):
        n, w, r, pad, dpml = 3.4, 1.0, 1.0, 4.0, 2.0
        sxy = 2 * (r + w + pad + dpml)
        fcen, df = 0.15, 0.1
        sim = mp.Simulation(
            cell_size=mp.Vector3(sxy, sxy), resolution=resolution,
            geometry=[mp.Cylinder(radius=r + w, material=mp.Medium(index=n)),
                      mp.Cylinder(radius=r, material=mp.Medium())],
            sources=[mp.Source(mp.GaussianSource(fcen, fwidth=df),
                               component=mp.Ez, center=mp.Vector3(r + 0.1))],
            boundary_layers=[mp.PML(dpml)],
            symmetries=[mp.Mirror(mp.Y)])
        h = mp.Harminv(mp.Ez, mp.Vector3(r + 0.1), fcen, df)
        sim.run(mp.after_sources(h), until_after_sources=after)
    return [(m.freq, m.Q, abs(m.amp)) for m in h.modes]


def match_modes(got, ref, tol: float) -> float:
    """Largest relative frequency gap between each well-formed mode
    (Q > 50, |amp| > 1e-4) of either list and the nearest mode of the
    other; raises when it exceeds `tol`."""
    def strong(ms):
        return [f for f, q, a in ms if q > 50 and a > 1e-4]
    worst = 0.0
    for a, b in ((got, ref), (ref, got)):
        fb = np.array([f for f, _, _ in b])
        for f in strong(a):
            if not len(fb):
                raise AssertionError(f"mode {f:.6f} has no counterpart")
            worst = max(worst, float(np.min(np.abs(fb - f)) / abs(f)))
    if not strong(ref):
        raise AssertionError("no well-formed ring mode found")
    if not worst <= tol:
        raise AssertionError(f"mode frequencies differ by {worst:.3e}")
    return worst


def phase_d(dev, cpu, tol: float = 1e-5, **kw) -> float:
    got = ring_modes(dev, **kw)
    ref = ring_modes(cpu, **kw)
    worst = match_modes(got, ref, tol)
    say(f"d: ring modes {dev.platform}: "
        + ", ".join(f"f={f:.7f} Q={q:.1f}" for f, q, _ in got)
        + f"; cpu: " + ", ".join(f"f={f:.7f} Q={q:.1f}" for f, q, _ in ref)
        + f"; worst relative gap {worst:.3e}")
    return worst


# --------------------------------------------------------------------- e
def mode_converter_problem(method: str, resolution: float = 10.0,
                           run_time: float = 120.0):
    """examples/mode_converter_opt.py's cell, waveguide and 8x8 design
    region, with a flux objective both gradient methods accept."""
    import jax.numpy as jnp
    import meep_nl_tpu as mp
    from meep_nl_tpu.adjoint import (DesignRegion, DesignVariables,
                                     OptimizationProblem)
    fcen = 0.6
    wg = mp.Block(size=mp.Vector3(mp.inf, 1.0, mp.inf),
                  material=mp.Medium(epsilon=6.0))
    sim = mp.Simulation(
        cell_size=mp.Vector3(8, 6), resolution=resolution, geometry=[wg],
        sources=[mp.Source(mp.GaussianSource(frequency=fcen, fwidth=0.2),
                           component=mp.Ez, center=mp.Vector3(-2.8, 0),
                           size=mp.Vector3(0, 2))],
        boundary_layers=[mp.PML(1.0)])
    flux = sim.add_flux(fcen, 0.0, 1, mp.FluxRegion(
        center=mp.Vector3(2.6, 0), size=mp.Vector3(0, 3)))

    def objective(dfts):
        total = 0.0
        for i in range(2):
            ek, hk = f"{flux.name}:0:e{i}", f"{flux.name}:0:h{i}"
            if ek in dfts:
                total = total + jnp.sum(jnp.real(dfts[ek]
                                                 * jnp.conj(dfts[hk])))
        return total

    return OptimizationProblem(
        simulation=sim, objective=objective,
        design_regions=[DesignRegion(
            DesignVariables(shape=(8, 8), eps_min=1.0, eps_max=6.0),
            center=[0, 0], size=[2, 2])],
        run_time=run_time, gradient_method=method)


def gradient(dev, method: str, **kw):
    import jax
    import jax.numpy as jnp
    with jax.default_device(dev):
        opt = mode_converter_problem(method, **kw)
        f, (g,) = opt(jnp.full((8, 8), 0.5, jnp.float32))
        return float(f), np.asarray(g)


def phase_e(dev, cpu, tol: float = 1e-3, **kw) -> dict:
    errs = {}
    for method in ("ad", "pair"):
        fd, gd = gradient(dev, method, **kw)
        fc, gc_ = gradient(cpu, method, **kw)
        errs[method] = rel_l2(gd, gc_)
        say(f"e: {method} gradient |g| {np.linalg.norm(gd):.6e} "
            f"(cpu {np.linalg.norm(gc_):.6e}), objective {fd:.6e} "
            f"(cpu {fc:.6e}), relative L2 vs cpu {errs[method]:.3e}")
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"gradients above {tol:g}: {bad}")
    return errs


# -------------------------------------------------------------- four cards
def phase_four(devs, cells=(768, 384, 384), steps: int = 100,
               tol: float = 1e-4) -> dict:
    """The flagship sharded over a 1-D x mesh of len(devs) devices against
    the same plan on devs[0]."""
    import jax
    from meep_nl_tpu.parallel import mesh as PM
    from meep_nl_tpu.stepper import step as S
    n = str(len(devs))
    with jax.default_device(devs[0]):
        sim, _ = flagship_sim(cells)
        sim.init_sim()
        plan, st0 = sim._plan, sim._state
        mesh = PM.make_mesh(len(devs), devices=list(devs))
        times, fields = {}, {}
        for name, fn in (
                ("1", lambda: S.run(plan, st0, steps, t0=0)),
                (n, lambda: PM.sharded_run(plan, mesh, st0, steps, t0=0))):
            jax.block_until_ready(fn())                   # compile + run
            t = time.perf_counter()
            out = jax.block_until_ready(fn())
            times[name] = (time.perf_counter() - t) / steps
            # to the host, so the next run has the device memory
            fields[name] = {k: np.asarray(jax.device_get(v))
                            for k, v in out["f"].items()}
            del out
    ref, got = fields["1"], fields[n]
    errs = compare_fields(got, ref, tol)
    say(f"four: {'x'.join(map(str, cells))} flagship, {steps} steps: "
        f"per-step {times['1'] * 1e3:.3f} ms on 1 card, "
        f"{times[n] * 1e3:.3f} ms on {n}; "
        f"sharded vs 1 card max relative L2 {max(errs.values()):.3e}")
    return {"errors": errs, "step_s": times}


# -------------------------------------------------------------------- main
def result_line(devs) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)
    devs = gpu_devices()
    if args.four_cards and len(devs) < 4:
        raise SystemExit(f"chip_smoke --four-cards: {len(devs)} GPU(s)")
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    phase_a(devs)
    dev, cpu = devs[0], jax.devices("cpu")[0]
    if args.four_cards:
        devs = devs[:4]
        phases = [("four", lambda: phase_four(devs))]
    else:
        devs = devs[:1]
        phases = [("b", lambda: phase_b(dev, cpu)),
                  ("c", lambda: phase_c(dev)),
                  ("d", lambda: phase_d(dev, cpu)),
                  ("e", lambda: phase_e(dev, cpu))]
    failed = []
    for name, fn in phases:
        t = time.perf_counter()
        try:
            fn()
        except Exception:                           # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
