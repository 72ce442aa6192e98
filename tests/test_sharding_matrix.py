"""GSPMD sharded runs equal the single-device run, case by case.

parallel.mesh.sharded_run is the only sharded path: the jnp step under
`lax.scan` with the fields and coefficients sharded over a device mesh,
XLA inserting the halo exchanges.  Each scene below runs on 2, 4 and 8
virtual CPU devices (a 1-D x mesh) and on 2x2, 2x4 and 4x2 meshes over x
and y, and must equal the unsharded `stepper.step.run` of the same plan in
every field and DFT accumulator, within fp32 roundoff of the dominant
field.
"""

import functools

import numpy as np
import jax
import pytest

import meep_nl_tpu as mp
from meep_nl_tpu.parallel import mesh as PM
from meep_nl_tpu.stepper.step import init_state, run

RES = 8.0
# 31 x cells -> 32 x sites: shard boundaries at sites 16 (2 shards),
# 8/16/24 (4) and every 4 (8); x = -L/2 + 16/RES is site 16
LX, LY, LZ = 31 / RES, 15 / RES, 1.5
X16 = -LX / 2 + 16 / RES
STEPS = 30


def _scene(name):
    """(Simulation, nsteps) for one scene."""
    lx = LX
    src_x = X16 - 0.5
    geometry, kw, flux = [], {}, []
    pml = [mp.PML(0.375)]
    nsteps = STEPS
    if name == "nl_ball_on_boundaries":
        med = mp.Medium(epsilon=4.0, chi2=0.3, chi2_full_tensor=True,
                        E_susceptibilities=[mp.LorentzianSusceptibility(
                            frequency=1.5, gamma=0.05, sigma=0.4)])
        geometry = [mp.Sphere(radius=0.6, center=mp.Vector3(X16),
                              material=med)]
    elif name == "source_on_boundary":
        src_x = X16
    elif name == "conductivity":
        geometry = [mp.Block(size=mp.Vector3(1.5, 0.75, 0.75),
                             center=mp.Vector3(X16),
                             material=mp.Medium(epsilon=2.0,
                                                D_conductivity=0.6,
                                                B_conductivity=0.4))]
    elif name in ("periodic_real_phase", "periodic_complex_phase"):
        pml = [mp.PML(0.375, direction="y"), mp.PML(0.375, direction="z")]
        kx = 0.0 if name == "periodic_real_phase" else 0.29 / lx
        kw["k_point"] = mp.Vector3(kx, 0, 0)
    elif name == "dft_monitors":
        flux = [mp.FluxRegion(center=mp.Vector3(X16 + 0.25),
                              size=mp.Vector3(0, 1.0, 1.0)),
                mp.FluxRegion(center=mp.Vector3(0, 0.3),
                              size=mp.Vector3(lx - 1.0, 0, 1.0))]
    elif name == "odd_span":
        lx = 37 / RES            # 38 live x sites, dead rows past them
        nsteps = STEPS + 1
    sim = mp.Simulation(
        cell_size=mp.Vector3(lx, LY, LZ), resolution=RES,
        geometry=geometry, eps_averaging=False, boundary_layers=pml,
        sources=[mp.Source(mp.GaussianSource(1.0, fwidth=1.5, cutoff=1.5),
                           component=mp.Ez, amplitude=2.0,
                           center=mp.Vector3(src_x, 0.1, 0.0))], **kw)
    for fr in flux:
        sim.add_flux(1.0, 0.5, 3, fr)
    sim.init_sim()
    return sim, nsteps


SCENES = ("nl_ball_on_boundaries", "source_on_boundary", "conductivity",
          "periodic_real_phase", "periodic_complex_phase", "dft_monitors",
          "odd_span")


@functools.lru_cache(maxsize=None)
def _single_device(name):
    sim, nsteps = _scene(name)
    plan = sim._plan
    ref = run(plan, init_state(plan), nsteps, t0=0)
    return plan, nsteps, jax.tree.map(np.asarray, {"f": ref["f"],
                                                   "dft": ref["dft"]})


def _assert_matches(name, mesh):
    plan, nsteps, ref = _single_device(name)
    out = PM.sharded_run(plan, mesh, init_state(plan), nsteps, t0=0)
    assert int(out["t"]) == nsteps
    ss = plan.storage_shape
    for ax, n in zip(range(len(mesh.shape)), mesh.devices.shape):
        assert ss[ax] % n == 0
    scale = max(np.max(np.abs(v)) for v in ref["f"].values())
    assert scale > 0
    for c, r in ref["f"].items():
        got = out["f"][c]
        assert len(got.sharding.device_set) == mesh.devices.size
        np.testing.assert_allclose(np.asarray(got), r, rtol=0,
                                   atol=5e-6 * scale, err_msg=c)
    for k, r in ref["dft"].items():
        np.testing.assert_allclose(np.asarray(out["dft"][k]), r, rtol=0,
                                   atol=5e-6 * scale * nsteps * plan.dt,
                                   err_msg=k)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_x_mesh_matches_single_device(name, n):
    _assert_matches(name, PM.make_mesh(n, shape=(n,)))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)])
def test_xy_mesh_matches_single_device(shape):
    """A 2-D mesh over x and y: 15 y cells -> 16 y sites, divisible by 4."""
    _assert_matches("nl_ball_on_boundaries",
                    PM.make_mesh(int(np.prod(shape)), shape=shape))
