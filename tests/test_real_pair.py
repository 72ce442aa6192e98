"""Real-pair complex-field stepper (plan.real_pair): complex state stored
as a leading (re, im) channel axis of real arrays, all kernels in real
arithmetic (MNT_REAL_PAIR=1), the analog of the reference's DOCMP unroll
(fields.cpp).  Native complex fields are the default on every backend.

Each test runs the same plan through the complex path and the real-pair
path and requires agreement to fp32 roundoff."""

import numpy as np
import pytest

import meep_nl_tpu as mnt
from meep_nl_tpu.core import grid as G
from meep_nl_tpu.stepper.plan import (MaterialSpec, PMLSpec, SrcVolSpec,
                                      compile_plan)
from meep_nl_tpu.stepper import step as S


def _src(gv, comp="ez", pos=None, amp=1.0):
    src_t = mnt.GaussianSource(frequency=0.8, fwidth=0.4)
    pts = gv.interp_weights(comp, pos or [0.0] * gv.ndim)
    idx = np.array([p for p, w in pts], np.int32)
    amps = np.array([w * amp for p, w in pts], np.complex128)
    return SrcVolSpec(comp, idx, amps, src_t)


def _compare(mk_plan, nsteps=30, atol=2e-6, probes=()):
    plan_c = mk_plan()
    plan_p = mk_plan()
    plan_p.real_pair = True
    out_c = S.run(plan_c, S.init_state(plan_c), nsteps, t0=0,
                  probes=probes)
    out_p = S.run(plan_p, S.init_state(plan_p), nsteps, t0=0,
                  probes=probes)
    st_c, st_p = (out_c[0], out_p[0]) if probes else (out_c, out_p)
    scale = max(float(np.max(np.abs(np.asarray(v))))
                for v in st_c["f"].values())
    assert scale > 0
    for c in st_c["f"]:
        ref = np.asarray(st_c["f"][c])
        got = np.asarray(st_p["f"][c])
        got_c = got[0] + 1j * got[1]
        np.testing.assert_allclose(got_c.real, ref.real, atol=atol * scale,
                                   err_msg=f"re f[{c}]")
        np.testing.assert_allclose(got_c.imag, ref.imag, atol=atol * scale,
                                   err_msg=f"im f[{c}]")
    for name in st_c["dft"]:
        np.testing.assert_allclose(np.asarray(st_p["dft"][name]),
                                   np.asarray(st_c["dft"][name]),
                                   atol=atol * scale, err_msg=name)
    if probes:
        ys_c, ys_p = out_c[1], out_p[1]
        for k in ys_c:
            ref = np.asarray(ys_c[k])
            got = np.asarray(ys_p[k])
            got = got[:, 0] + 1j * got[:, 1]
            np.testing.assert_allclose(got.real, ref.real,
                                       atol=atol * scale, err_msg=k)
            np.testing.assert_allclose(got.imag, ref.imag,
                                       atol=atol * scale, err_msg=k)


def test_bloch_2d():
    """Oblique Bloch k in a periodic 2D cell (complex wrap phases)."""
    def mk():
        gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
        return compile_plan(gv, MaterialSpec(chi1inv={}),
                            sources=[_src(gv, "ez", [0.3, -0.2],
                                          amp=1 + 0.5j)],
                            periodic=(True, True), bloch_k=(0.13, 0.31),
                            complex_fields=True)
    _compare(mk)


def test_bloch_3d_pml_z():
    def mk():
        gv = G.GridVolume.create("3d", [1.5, 1.5, 2.0], 8)
        return compile_plan(gv, MaterialSpec(chi1inv={}),
                            sources=[_src(gv, "ex", [0.1, 0.0, -0.3])],
                            periodic=(True, True, False),
                            bloch_k=(0.2, 0.1, 0.0),
                            pmls=[PMLSpec("z", 0.5)],
                            complex_fields=True)
    _compare(mk, nsteps=24)


def test_cylindrical_m1():
    """Cylindrical m=1: i*m/r terms and axis corrections."""
    def mk():
        gv = G.GridVolume.create("cyl", [2.0, 3.0], 10)
        return compile_plan(gv, MaterialSpec(chi1inv={}),
                            sources=[_src(gv, "ep", [0.8, 0.0])],
                            pmls=[PMLSpec("r", 0.5, side=+1),
                                  PMLSpec("z", 0.5)],
                            m=1, complex_fields=True)
    _compare(mk, nsteps=40)


def test_dispersive_bloch():
    """Lorentz pole + Bloch phases (complex ADE state)."""
    def mk():
        from meep_nl_tpu.stepper.plan import PolSpec
        gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
        shape = gv.shape
        sig = np.zeros(shape)
        sig[5:12, 5:12] = 0.4
        pol = PolSpec(field_type="e", omega0=1.5, gamma=0.1,
                      sigma={("ez", "z"): sig})
        return compile_plan(gv, MaterialSpec(chi1inv={}, pols=[pol]),
                            sources=[_src(gv, "ez", [0.3, -0.2])],
                            periodic=(True, True), bloch_k=(0.11, 0.0),
                            complex_fields=True)
    _compare(mk, nsteps=40, atol=5e-6)


def test_dft_monitor_real_pair():
    """DTFT accumulators agree through the real-pair path."""
    def mk():
        from meep_nl_tpu.stepper import monitors as M
        gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
        freqs = np.linspace(0.6, 1.0, 3)
        dfts = M.flux_specs(gv, "fl", "x", [0.5, 0.0], [0.0, 1.0], freqs)
        return compile_plan(gv, MaterialSpec(chi1inv={}),
                            sources=[_src(gv, "ez", [-0.3, 0.0])],
                            periodic=(True, True), bloch_k=(0.07, 0.0),
                            dfts=dfts, complex_fields=True)
    _compare(mk, nsteps=30)


def test_probes_real_pair():
    probes = (S.ProbeSpec("p0", "ez", np.array([[11, 9]], np.int32),
                          np.array([1.0 + 0.25j])),)

    def mk():
        gv = G.GridVolume.create("2d", [2.0, 2.0], 10)
        return compile_plan(gv, MaterialSpec(chi1inv={}),
                            sources=[_src(gv, "ez", [0.3, -0.2])],
                            periodic=(True, True), bloch_k=(0.13, 0.31),
                            complex_fields=True)
    _compare(mk, probes=probes)


# -- through the Simulation API: native complex fields are the default, and
# MNT_REAL_PAIR=1 must reproduce them ---------------------------------------

def _sim_bloch_2d():
    return mnt.Simulation(
        cell_size=mnt.Vector3(2, 2), resolution=10,
        k_point=mnt.Vector3(0.13, 0.31),
        geometry=[mnt.Block(size=mnt.Vector3(0.6, 0.6, mnt.inf),
                            material=mnt.Medium(epsilon=3.0))],
        sources=[mnt.Source(mnt.GaussianSource(0.8, fwidth=0.4),
                            component=mnt.Ez, amplitude=1 + 0.5j,
                            center=mnt.Vector3(0.3, -0.2))])


def _sim_bloch_3d():
    return mnt.Simulation(
        cell_size=mnt.Vector3(1.5, 1.5, 2.0), resolution=8,
        k_point=mnt.Vector3(0.2, 0.1, 0.0),
        boundary_layers=[mnt.PML(0.5, direction=mnt.Z)],
        sources=[mnt.Source(mnt.GaussianSource(0.8, fwidth=0.4),
                            component=mnt.Ex,
                            center=mnt.Vector3(0.1, 0.0, -0.3))])


def _sim_cyl(m):
    return mnt.Simulation(
        cell_size=mnt.Vector3(2.0, 0, 3.0), resolution=10,
        dimensions="cyl", m=m, boundary_layers=[mnt.PML(0.5)],
        sources=[mnt.Source(mnt.GaussianSource(0.6, fwidth=0.3),
                            component=mnt.Er,
                            center=mnt.Vector3(0.8, 0, 0.1))])


def _sim_bfast():
    s = 0.5
    return mnt.Simulation(
        cell_size=mnt.Vector3(0.1, 0.1, 4), resolution=20,
        Courant=(1 - s) / np.sqrt(3),
        geometry=[mnt.Block(size=mnt.Vector3(mnt.inf, mnt.inf, 1.0),
                            center=mnt.Vector3(0, 0, 0.8),
                            material=mnt.Medium(epsilon=2.25))],
        sources=[mnt.Source(mnt.GaussianSource(1.0, fwidth=0.5),
                            component=mnt.Ex, center=mnt.Vector3(0, 0, -1.0),
                            size=mnt.Vector3(0.1, 0.1, 0))],
        boundary_layers=[mnt.PML(1.0, direction=mnt.Z)],
        k_point=mnt.Vector3(0, 0, 0), bfast_scaled_k=mnt.Vector3(s, 0, 0),
        eps_averaging=False)


SIM_CASES = {"bloch_2d": _sim_bloch_2d, "bloch_3d": _sim_bloch_3d,
             "cyl_m1": lambda: _sim_cyl(1), "cyl_m2": lambda: _sim_cyl(2),
             "bfast": _sim_bfast}


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_simulation_native_complex_equals_real_pair(name, monkeypatch):
    monkeypatch.delenv("MNT_REAL_PAIR", raising=False)
    sim_c = SIM_CASES[name]()
    sim_c.run(until=40 * sim_c.dt)
    assert sim_c._plan.complex_fields and not sim_c._plan.real_pair
    monkeypatch.setenv("MNT_REAL_PAIR", "1")
    sim_p = SIM_CASES[name]()
    sim_p.run(until=40 * sim_p.dt)
    assert sim_p._plan.real_pair
    f_c = {k: np.asarray(v) for k, v in sim_c._state["f"].items()}
    scale = max(np.max(np.abs(v)) for v in f_c.values())
    assert scale > 0
    for c, ref in f_c.items():
        assert np.iscomplexobj(ref), c
        got = np.asarray(sim_p._state["f"][c])
        np.testing.assert_allclose(got[0] + 1j * got[1], ref, rtol=0,
                                   atol=2e-6 * scale, err_msg=c)
