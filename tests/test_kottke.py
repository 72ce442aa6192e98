"""Full-tensor Kottke subpixel smoothing (scene.rasterize; reference
src/anisotropic_averaging.cpp + Kottke-Farjadpour-Johnson 2008):
interface voxels get eps_eff^{-1} = <1/eps> nn^T + <eps>^{-1}(I - nn^T),
including the off-diagonal n_i n_j rows that feed the stepper's OFFDIAG
path."""

import numpy as np
import pytest

import meep_nl_tpu as mp
from meep_nl_tpu.core import grid as G
from meep_nl_tpu.models import scene


def _halfplane_45(eps=12.0):
    # half-plane x + y < 0 via a large triangular prism whose hypotenuse
    # passes through the origin with slope -1
    return [mp.Prism(vertices=[mp.Vector3(-100, 100), mp.Vector3(100, -100),
                               mp.Vector3(-300, -300)],
                     height=mp.inf, material=mp.Medium(epsilon=eps))]


def test_tilted_interface_offdiag():
    gv = G.GridVolume.create("2d", [4.0, 4.0], 16.0)
    mat = scene.rasterize(gv, _halfplane_45(), mp.Medium(),
                          eps_averaging=True, subpixel_n=4,
                          subpixel_tensor=True)
    ex_rows = mat.chi1inv["ex"]
    ey_rows = mat.chi1inv["ey"]
    assert "y" in ex_rows and "x" in ey_rows, "off-diagonal rows missing"
    od_xy = ex_rows["y"]
    od_yx = ey_rows["x"]
    # off-diagonal support only at the interface band
    assert np.any(np.abs(od_xy) > 1e-4)
    assert np.count_nonzero(np.abs(od_xy) > 1e-6) < od_xy.size * 0.2
    # for a 45-degree normal n = (1,1)/sqrt2: n_x n_y = +1/2, so the
    # off-diagonal entry is positive with magnitude up to
    # (<1/eps> - 1/<eps>)/2
    band = np.abs(od_xy) > 1e-4
    assert np.all(od_xy[band] > 0)
    e1, e2 = 1.0, 12.0
    max_delta = (0.5 * (1 / e1 + 1 / e2) - 1.0 / (0.5 * (e1 + e2)))
    assert od_xy.max() < 0.5 * max_delta * 1.05
    # tensor symmetry: the ey row's x entry mirrors the ex row's y entry
    assert abs(od_xy.max() - od_yx.max()) < 0.2 * od_xy.max()
    # diagonal entries stay between the harmonic and arithmetic bounds
    diag = ex_rows["x"]
    assert np.all(diag >= 1.0 / e2 - 1e-9) and np.all(diag <= 1.0 + 1e-9)


def test_axis_aligned_no_offdiag():
    gv = G.GridVolume.create("2d", [4.0, 4.0], 16.0)
    geom = [mp.Block(center=mp.Vector3(-1, 0),
                     size=mp.Vector3(2, mp.inf, mp.inf),
                     material=mp.Medium(epsilon=12))]
    mat = scene.rasterize(gv, geom, mp.Medium(), eps_averaging=True,
                          subpixel_n=4, subpixel_tensor=True)
    assert "y" not in mat.chi1inv.get("ex", {})
    assert "x" not in mat.chi1inv.get("ey", {})


def test_analytic_normals():
    """Per-shape normal_at returns exact unit outward surface normals
    (the role of sphere-quad.cpp + normal_to_fixed_object)."""
    p = lambda *xyz: np.array([xyz], float)
    s = mp.Sphere(radius=1.0, center=mp.Vector3(1, 0, 0))
    np.testing.assert_allclose(s.normal_at(p(3, 0, 0))[0], [1, 0, 0])
    np.testing.assert_allclose(s.normal_at(p(1, -2, 0))[0], [0, -1, 0])
    b = mp.Block(size=mp.Vector3(2, 4, mp.inf))
    np.testing.assert_allclose(b.normal_at(p(0.9, 0.1, 0))[0], [1, 0, 0])
    np.testing.assert_allclose(b.normal_at(p(0.1, -1.9, 0))[0], [0, -1, 0])
    c = mp.Cylinder(radius=1.0, height=2.0)
    np.testing.assert_allclose(c.normal_at(p(0.95, 0, 0))[0], [1, 0, 0])
    np.testing.assert_allclose(c.normal_at(p(0.1, 0, 0.95))[0], [0, 0, 1])
    e = mp.Ellipsoid(size=mp.Vector3(2, 4, 2))
    n = e.normal_at(p(0, 2, 0))[0]
    np.testing.assert_allclose(n, [0, 1, 0], atol=1e-12)
    # 45-degree point on a circle-ish ellipsoid reduces to sphere normal
    e2 = mp.Ellipsoid(size=mp.Vector3(2, 2, 2))
    n2 = e2.normal_at(p(0.7071, 0.7071, 0))[0]
    np.testing.assert_allclose(n2, [2**-0.5, 2**-0.5, 0], atol=1e-6)
    pr = mp.Prism(vertices=[mp.Vector3(-1, -1), mp.Vector3(1, -1),
                            mp.Vector3(1, 1), mp.Vector3(-1, 1)],
                  height=mp.inf)
    np.testing.assert_allclose(pr.normal_at(p(0.9, 0.2, 0))[0], [1, 0, 0])
    np.testing.assert_allclose(pr.normal_at(p(-0.3, -1.1, 0))[0], [0, -1, 0])
    # clockwise vertex order flips nothing (orientation-aware)
    pr2 = mp.Prism(vertices=[mp.Vector3(-1, 1), mp.Vector3(1, 1),
                             mp.Vector3(1, -1), mp.Vector3(-1, -1)],
                   height=mp.inf)
    np.testing.assert_allclose(pr2.normal_at(p(0.9, 0.2, 0))[0], [1, 0, 0])


def _disk_te_mode(res, eps_averaging, subpixel_tensor, until=300):
    """TE (Ex/Ey/Hz) whispering-gallery mode of an n=3.4, r=1 disk.
    Exact m=4 resonance from the Hankel dispersion relation
    (1/n) J'_m(nkR)/J_m(nkR) = H'_m(kR)/H_m(kR): f=0.3452936, Q=402."""
    r, pad, dpml = 1.0, 2.0, 1.0
    sxy = 2.0 * (r + pad + dpml)
    sim = mp.Simulation(
        cell_size=mp.Vector3(sxy, sxy), resolution=res,
        geometry=[mp.Cylinder(radius=r, material=mp.Medium(index=3.4),
                              center=mp.Vector3())],
        eps_averaging=eps_averaging, subpixel_n=8,
        subpixel_tensor=subpixel_tensor,
        sources=[mp.Source(mp.GaussianSource(frequency=0.345, fwidth=0.1),
                           component=mp.Ex, center=mp.Vector3(0.72, 0.1))],
        boundary_layers=[mp.PML(dpml)])
    h = mp.Harminv(mp.Ex, mp.Vector3(0.65, -0.2), 0.345, 0.1)
    sim.run(mp.after_sources(h), until_after_sources=until)
    good = [m for m in h.modes if m.Q > 100 and m.amp > 1e-6
            and abs(m.freq - 0.3452936) < 0.02]
    assert good, "disk mode not found"
    good.sort(key=lambda m: abs(m.freq - 0.3452936))
    return good[0]


F_DISK_EXACT = 0.3452936


def test_disk_tensor_convergence():
    """Analytic-normal tensor smoothing converges to the exact disk
    resonance: error at least ~halves per resolution doubling (measured
    1.64e-2 / 8.4e-3 / 3.7e-3 / 1.0e-3 at res 10/20/40/80, order
    rising to ~1.9; staircase and diagonal-blend plateau at 1-2e-3)."""
    e10 = abs(_disk_te_mode(10, True, True).freq - F_DISK_EXACT)
    e20 = abs(_disk_te_mode(20, True, True).freq - F_DISK_EXACT)
    assert e10 / e20 > 1.7, (e10, e20)
    assert e20 < 1.0e-2


@pytest.mark.slow
def test_disk_tensor_beats_staircase_highres():
    """By res 40-80 the tensor path's error falls below the staircase
    plateau (the subpixel-smoothing win of anisotropic_averaging.cpp)."""
    et = abs(_disk_te_mode(40, True, True).freq - F_DISK_EXACT)
    es = abs(_disk_te_mode(40, False, False).freq - F_DISK_EXACT)
    e20 = abs(_disk_te_mode(20, True, True).freq - F_DISK_EXACT)
    assert et < 4.5e-3 * F_DISK_EXACT
    assert et < e20 / 1.7
    # staircase stalls: its res-40 error is no better than its res-10 one
    e10s = abs(_disk_te_mode(10, False, False).freq - F_DISK_EXACT)
    assert es > 0.5 * e10s


def test_tilted_interface_runs():
    """End-to-end: the Kottke off-diagonal rows flow through the stepper
    (OFFDIAG path) without blowing up."""
    sim = mp.Simulation(
        cell_size=mp.Vector3(4, 4), resolution=16,
        geometry=_halfplane_45(), subpixel_tensor=True,
        sources=[mp.Source(mp.GaussianSource(frequency=0.6, fwidth=0.2),
                           component=mp.Ex, center=mp.Vector3(1.2, 1.2))],
        boundary_layers=[mp.PML(0.8)])
    sim.run(until=25)
    ex = np.asarray(sim.get_array(component=mp.Ex, center=mp.Vector3(),
                                  size=mp.Vector3(2, 2)))
    assert np.all(np.isfinite(ex))
    assert np.abs(ex).max() < 1e3  # stable
