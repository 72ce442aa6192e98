"""2D cells with an out-of-plane wavevector (the reference's special_kz
/ kz_2d, python/tests/test_special_kz.py + fields.cpp beta): the
dropped d/dz curl terms become the exact i*beta coupling.

Gates: the vacuum Bloch eigenfrequency against the EXACT discrete
dispersion of the Yee scheme with an unsinced beta term,

    sin^2(w dt/2) = (dt/2)^2 [ sum_i (2/dx)^2 sin^2(k_i dx/2) + beta^2 ],

TE/TM coupling on/off, and the real-pair channel equivalence."""

import numpy as np
import pytest

import meep_nl_tpu as mnt


def _disc_freq(kx, ky, kz, res, courant=0.25):
    dx = 1.0 / res
    dt = courant * dx
    s = ((2.0 / dx) ** 2 * (np.sin(np.pi * kx * dx) ** 2
                            + np.sin(np.pi * ky * dx) ** 2)
         + (2 * np.pi * kz) ** 2)
    return 2.0 / dt * np.arcsin(dt / 2.0 * np.sqrt(s)) / (2 * np.pi)


def _sim(kpt, res=16, courant=0.25):
    return mnt.Simulation(
        cell_size=mnt.Vector3(1.0, 1.0), resolution=res,
        sources=[mnt.Source(
            mnt.GaussianSource(frequency=0.36, fwidth=0.25),
            component=mnt.Ex, center=mnt.Vector3(0.1, -0.17))],
        k_point=kpt, Courant=courant)


def test_kz_vacuum_dispersion():
    """Harminv frequency of the lowest Bloch mode matches the discrete
    dispersion with the beta^2 term to ~1e-4 (the gate fails by ~40% if
    beta is dropped)."""
    kx, kz = 0.2, 0.3
    sim = _sim(mnt.Vector3(kx, 0, kz))
    h = mnt.Harminv(mnt.Ex, mnt.Vector3(-0.23, 0.11), 0.36, 0.25)
    sim.run(h, until_after_sources=150)
    f_ex = _disc_freq(kx, 0.0, kz, 16)
    assert h.modes, "no modes found"
    m = min(h.modes, key=lambda mm: abs(mm.freq - f_ex))
    assert abs(m.freq - f_ex) < 2e-4, (m.freq, f_ex)
    # and WITHOUT beta the mode sits elsewhere (regression guard that
    # the coupling actually changed the physics)
    f_nok = _disc_freq(kx, 0.0, 0.0, 16)
    assert abs(m.freq - f_nok) > 50 * 2e-4


def test_kz_couples_te_tm():
    """An Ex source (TE sector: Ex/Ey/Hz) excites the TM sector
    (Ez/Hx/Hy) only when beta != 0."""
    sim = _sim(mnt.Vector3(0.2, 0, 0.3))
    sim.run(until=8.0)
    ex = np.abs(np.asarray(sim.get_array(mnt.Ex))).max()
    hy = np.abs(np.asarray(sim.get_array(mnt.Hy))).max()
    assert hy > 1e-3 * ex, "beta must couple TE<->TM"
    sim0 = mnt.Simulation(
        cell_size=mnt.Vector3(1.0, 1.0), resolution=16,
        sources=[mnt.Source(
            mnt.GaussianSource(frequency=0.36, fwidth=0.25),
            component=mnt.Ex, center=mnt.Vector3(0.1, -0.17))],
        k_point=mnt.Vector3(0.2, 0, 0.0), Courant=0.25,
        force_all_components=True)
    sim0.run(until=8.0)
    ex0 = np.abs(np.asarray(sim0.get_array(mnt.Ex))).max()
    hy0 = np.abs(np.asarray(sim0.get_array(mnt.Hy))).max()
    assert hy0 < 1e-6 * ex0, "no coupling at kz = 0"


def test_kz_pml_stable():
    """beta + PML: fields stay finite and decay after the pulse."""
    sim = mnt.Simulation(
        cell_size=mnt.Vector3(3.0, 2.0), resolution=16,
        boundary_layers=[mnt.PML(0.5)],
        sources=[mnt.Source(mnt.GaussianSource(frequency=1.0, fwidth=0.5),
                            component=mnt.Ex, center=mnt.Vector3())],
        k_point=mnt.Vector3(0, 0, 0.4), Courant=0.25)
    sim.run(until=6.0)
    peak = np.abs(np.asarray(sim.get_array(mnt.Ex))).max()
    sim.run(until=14.0)
    late = np.abs(np.asarray(sim.get_array(mnt.Ex))).max()
    assert np.isfinite(late) and late < 0.05 * peak


def test_kz_courant_guard():
    """An unstable Courant/beta combination is a hard error."""
    with pytest.raises(ValueError, match="unstable"):
        sim = mnt.Simulation(
            cell_size=mnt.Vector3(1.0, 1.0), resolution=8,
            sources=[mnt.Source(mnt.GaussianSource(1.0, fwidth=0.5),
                                component=mnt.Ex, center=mnt.Vector3())],
            k_point=mnt.Vector3(0, 0, 5.0), Courant=0.5)
        sim.init_sim()


def test_kz_real_pair_equivalence():
    """The real-pair channel (MNT_REAL_PAIR storage) reproduces the complex
    path with beta active."""
    import os
    os.environ["MNT_REAL_PAIR"] = "1"
    try:
        sim_p = _sim(mnt.Vector3(0.2, 0, 0.3))
        sim_p.run(until=5.0)
        assert sim_p._plan.real_pair
        ex_p = np.asarray(sim_p.get_array(mnt.Ex))
    finally:
        os.environ.pop("MNT_REAL_PAIR", None)
    sim_c = _sim(mnt.Vector3(0.2, 0, 0.3))
    sim_c.run(until=5.0)
    assert not sim_c._plan.real_pair
    ex_c = np.asarray(sim_c.get_array(mnt.Ex))
    scale = np.abs(ex_c).max()
    np.testing.assert_allclose(ex_p, ex_c, atol=5e-6 * scale)
