"""The XLA main path against an unblocked float64 reference.

`Simulation.run` advances the fields through `stepper.step.run`: blocks of
MNT_FINITE_BLOCK steps, each a cached jitted `lax.scan` of `make_step`,
continued across run() calls from the host-side step counter.  Every case
here drives that path in float32 (two run() calls, so blocks of two lengths
and a t0 continuation) and requires it to equal ONE float64 loop over
`make_step`, step by step from t=0, on the same scene: fields, DFT
accumulators and probe series, within fp32 roundoff of the dominant field.

The configuration matrix: every subset of x/y/z uPML, inhomogeneous eps
(with and without subpixel averaging), D/B conductivity, Lorentz, Drude,
chi3, chi2-Newton and Lorentz+chi2 media, x-periodic cells at k=0, at the
zone edge and at oblique k (native complex fields), DFT flux monitors,
point probes, and odd and even step counts.
"""

import contextlib
import functools

import numpy as np
import jax
import pytest

import meep_nl_tpu as mp
from meep_nl_tpu.models.run_control import WeightedProbe
from meep_nl_tpu.stepper import step as S

CELL = (2.0, 1.75, 1.5)
RES = 8.0
DPML = 0.375


def _medium(kind):
    lor = mp.LorentzianSusceptibility(frequency=1.1, gamma=0.05, sigma=0.5)
    return {
        "eps": mp.Medium(epsilon=3.0),
        "cond_d": mp.Medium(epsilon=2.0, D_conductivity=0.8),
        "cond_b": mp.Medium(epsilon=2.0, B_conductivity=0.8),
        "cond_db": mp.Medium(epsilon=2.0, D_conductivity=0.5,
                             B_conductivity=0.5),
        "lorentz": mp.Medium(epsilon=2.0, E_susceptibilities=[lor]),
        "drude": mp.Medium(epsilon=1.5, E_susceptibilities=[
            mp.DrudeSusceptibility(frequency=1.2, gamma=0.1, sigma=0.6)]),
        "chi3": mp.Medium(epsilon=2.0, chi3=0.5),
        "chi2_newton": mp.Medium(epsilon=2.0, chi2=0.4,
                                 chi2_full_tensor=True),
        "lorentz_chi2": mp.Medium(epsilon=2.0, chi2=0.4,
                                  chi2_full_tensor=True,
                                  E_susceptibilities=[lor]),
    }[kind]


# name -> scene: uPML axes, medium, geometry shape, eps averaging,
# x-periodic k_x (in units of the zone edge 1/(2 L_x)), flux plane, probe
CASES = {f"pml_{ax or 'none'}": dict(pml=ax)
         for ax in ("", "x", "y", "z", "xy", "xz", "yz", "xyz")}
CASES.update({
    "eps_block": dict(medium="eps"),
    "eps_sphere_averaged": dict(medium="eps", shape="sphere", avg=True),
    "cond_d": dict(medium="cond_d"),
    "cond_b": dict(medium="cond_b"),
    "cond_db_no_pml": dict(medium="cond_db", pml=""),
    "lorentz": dict(medium="lorentz"),
    "drude": dict(medium="drude"),
    "chi3": dict(medium="chi3"),
    "chi2_newton": dict(medium="chi2_newton"),
    "lorentz_chi2": dict(medium="lorentz_chi2", shape="sphere"),
    "periodic_k0": dict(pml="yz", kx=0.0),
    "periodic_zone_edge": dict(pml="yz", kx=1.0, medium="eps"),
    "periodic_oblique": dict(pml="yz", kx=0.37),
    "periodic_oblique_lorentz": dict(pml="yz", kx=0.37, medium="lorentz"),
    "flux": dict(flux=True),
    "flux_lorentz_chi2": dict(flux=True, medium="lorentz_chi2"),
    "probe": dict(probe=True, medium="eps"),
    "probe_oblique": dict(probe=True, pml="yz", kx=0.37),
})


def _sim(cfg, dtype):
    pml = cfg.get("pml", "xyz")
    geometry = []
    if cfg.get("medium"):
        med = _medium(cfg["medium"])
        if cfg.get("shape") == "sphere":
            geometry = [mp.Sphere(radius=0.45, center=mp.Vector3(0.2),
                                  material=med)]
        else:
            geometry = [mp.Block(size=mp.Vector3(0.75, 0.625, 0.5),
                                 center=mp.Vector3(0.25, 0.0, 0.0),
                                 material=med)]
    kw = {}
    if "kx" in cfg:
        kw["k_point"] = mp.Vector3(cfg["kx"] / (2 * CELL[0]), 0, 0)
    sim = mp.Simulation(
        cell_size=mp.Vector3(*CELL), resolution=RES, geometry=geometry,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.5, cutoff=1.5),
                           component=mp.Ez, amplitude=2.0,
                           center=mp.Vector3(-0.4, 0.15, 0.1))],
        boundary_layers=[mp.PML(DPML, direction=d) for d in pml],
        eps_averaging=cfg.get("avg", False), dtype=dtype, **kw)
    flux = None
    if cfg.get("flux"):
        flux = sim.add_flux(1.0, 0.5, 3, mp.FluxRegion(
            center=mp.Vector3(0.0), size=mp.Vector3(0, 0.75, 0.75)))
    return sim, flux


def _probe():
    idx = np.array([[9, 7, 6], [10, 8, 6], [4, 5, 7]], np.int32)
    return WeightedProbe("ez", idx, np.array([0.5, 0.25, 1.0]))


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _reference(name, steps):
    """ONE float64 loop over make_step from t=0: (fields, dfts, series)."""
    cfg = CASES[name]
    with _x64():
        sim, _ = _sim(cfg, np.float64)
        sim.init_sim()
        plan, st = sim._plan, sim._state
        step = jax.jit(S.make_step(plan))
        xs = S.build_xs(plan, steps, 0)
        pr = _probe()
        series = []
        for i in range(steps):
            st = step(st, {k: v[i] for k, v in xs.items()}, plan.coefs)
            f = np.asarray(st["f"][pr.c])
            series.append(sum(w * f[tuple(ix)]
                              for ix, w in zip(pr.indices, pr.weights)))
        return ({k: np.asarray(v) for k, v in st["f"].items()},
                {k: np.asarray(v) for k, v in st["dft"].items()},
                np.asarray(series))


@pytest.mark.parametrize("steps", [17, 24])
@pytest.mark.parametrize("block", [4, 7])
@pytest.mark.parametrize("name", sorted(CASES))
def test_blocked_run_matches_float64_loop(name, block, steps, monkeypatch):
    cfg = CASES[name]
    monkeypatch.setenv("MNT_FINITE_BLOCK", str(block))
    sim, flux = _sim(cfg, np.float32)
    probe = _probe() if cfg.get("probe") else None
    extra = [probe] if probe is not None else []
    first = steps // 2
    sim.run(*extra, until=first * sim.dt)
    sim.run(*extra, until=(steps - first) * sim.dt)
    assert sim._t == steps
    assert sim._plan.real_pair is False
    f_ref, dft_ref, series_ref = _reference(name, steps)

    scale = max(np.max(np.abs(v)) for v in f_ref.values())
    assert scale > 0
    tol = 2e-5 * scale
    for c, ref in f_ref.items():
        got = np.asarray(sim._state["f"][c])
        assert got.dtype in (np.float32, np.complex64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=c)
    # an accumulator sums ~steps*dt of weighted field samples, so its
    # roundoff is set by the dominant field over the run
    for k, ref in dft_ref.items():
        got = np.asarray(sim._state["dft"][k])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * steps * sim.dt, err_msg=k)
    if flux is not None:
        assert dft_ref and np.max(np.abs(np.asarray(
            sim.get_fluxes(flux)))) > 0
    if probe is not None:
        assert probe.data.shape == (steps,)
        np.testing.assert_allclose(probe.data, series_ref, rtol=0,
                                   atol=tol)
    # the runners were reused, not retraced per block: one per distinct
    # block length (plus at most one per continuation remainder)
    assert len(sim._plan._run_cache) <= 4
