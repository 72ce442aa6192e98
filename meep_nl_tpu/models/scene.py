"""Scene rasterization: GeometricObject list -> MaterialSpec on Yee sites.

The analog of meepgeom.cpp `set_materials_from_geometry` (meepgeom.cpp:233) +
the subpixel smoothing of anisotropic_averaging.cpp.  Setup runs once in
NumPy (SURVEY.md section 7: the setup pass stays host-side); only the stepper
runs on the accelerator.

Subpixel scheme (round-1 "Kottke-lite"): each component site's voxel is
supersampled; for interface voxels we estimate the interface normal from the
fill-fraction gradient and combine
    einv_eff = <1/eps> * n_d^2 + (1/<eps>) * (1 - n_d^2)
i.e. harmonic averaging along the normal and arithmetic tangentially --- the
diagonal part of the reference's Kottke tensor average
(anisotropic_averaging.cpp:90 eff_chi1inv_row).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import grid as G
from ..stepper.plan import MaterialSpec, PolSpec
from .geom import GeometricObject, Medium, Vector3, _v3


def _material_at(pts: np.ndarray, geometry: Sequence[GeometricObject],
                 default: Medium) -> List[np.ndarray]:
    """Index of the material governing each point.  "When objects overlap,
    later objects in the list take precedence"
    (doc/docs/Python_User_Interface.md:136).  Returns an int index array;
    -1 = default material."""
    idx = np.full(pts.shape[:-1], -1, dtype=np.int32)
    for i in range(len(geometry)):       # later objects overwrite earlier
        mask = geometry[i].inside(pts)
        idx = np.where(mask, i, idx)
    return idx


def _eps_of(idx: np.ndarray, geometry, default: Medium, dind: int) -> np.ndarray:
    """Diagonal epsilon entry `dind` (0/1/2 for x/y/z) per point."""
    out = np.full(idx.shape, tuple(default.eps_diag_vec())[dind])
    for i, obj in enumerate(geometry):
        v = tuple(obj.material.eps_diag_vec())[dind]
        out = np.where(idx == i, v, out)
    return out


def _scalar_of(idx: np.ndarray, geometry, default: Medium, getter) -> np.ndarray:
    out = np.full(idx.shape, getter(default), dtype=np.float64)
    for i, obj in enumerate(geometry):
        out = np.where(idx == i, getter(obj.material), out)
    return out


def _site_points(gv: G.GridVolume, c: str) -> np.ndarray:
    """(shape..., 3) absolute coordinates of component c's sample sites."""
    coords = [gv.comp_coords(c, ax) for ax in range(gv.ndim)]
    mesh = np.meshgrid(*coords, indexing="ij")
    pts = np.zeros(gv.shape + (3,))
    # map grid axes onto (x, y, z) slots
    for ax, d in enumerate(gv.axes):
        slot = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}[d]
        pts[..., slot] = mesh[ax]
    if gv.dim == "1d":
        pts[..., 2] = mesh[0]
        pts[..., 0] = 0.0
    return pts


def _subsample_offsets(gv: G.GridVolume, n: int) -> np.ndarray:
    """(n^ndim, 3) offsets spanning one voxel around a site."""
    one = (np.arange(n) + 0.5) / n - 0.5
    grids = np.meshgrid(*([one] * gv.ndim), indexing="ij")
    offs = np.zeros((n ** gv.ndim, 3))
    for ax, d in enumerate(gv.axes):
        slot = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}[d]
        offs[:, slot] = grids[ax].ravel() * gv.dx
    if gv.dim == "1d":
        offs[:, 2] = grids[0].ravel() * gv.dx
        offs[:, 0] = 0.0
    return offs


def _corner_offsets(gv: G.GridVolume) -> List[np.ndarray]:
    """The 2^ndim voxel-corner offsets around a site."""
    import itertools
    half = 0.5 * gv.dx
    offs = []
    for combo in itertools.product((-half, half), repeat=gv.ndim):
        off = np.zeros(3)
        for ax, v in enumerate(combo):
            slot = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}[gv.axes[ax]]
            off[slot] = v
        if gv.dim == "1d":
            off[2] = combo[0]
            off[0] = 0.0
        offs.append(off)
    return offs


def _analytic_normals(gv: G.GridVolume, pts: np.ndarray,
                      geometry: Sequence[GeometricObject]
                      ) -> Optional[np.ndarray]:
    """(shape, 3) exact interface normals at voxels whose governing object
    boundary crosses them; NaN where no analytic normal is available.

    The voxel's visible boundary belongs to the LAST (topmost, by the
    later-objects-take-precedence rule) object whose inside() varies over
    the voxel corners; its normal_at gives the exact surface normal — the
    role of the reference's normal_to_fixed_object + sphere-quad
    quadrature (anisotropic_averaging.cpp:27, sphere-quad.cpp)."""
    normals = None
    corner = _corner_offsets(gv)
    for obj in geometry:                      # later objects overwrite
        ins = [obj.inside(pts + off) for off in corner]
        varies = np.logical_or.reduce(ins) & ~np.logical_and.reduce(ins)
        if not varies.any():
            continue
        n = obj.normal_at(pts)
        if normals is None:
            normals = np.full(pts.shape, np.nan)
        normals[varies] = np.nan if n is None else n[varies]
    return normals


def rasterize(gv: G.GridVolume, geometry: Sequence[GeometricObject],
              default_material: Medium = Medium(),
              eps_averaging: bool = True,
              subpixel_n: int = 3,
              subpixel_tensor: bool = False,
              live_e: Optional[Sequence[str]] = None,
              live_h: Optional[Sequence[str]] = None) -> MaterialSpec:
    geometry = list(geometry)
    live_e = list(live_e) if live_e is not None else list(gv.e_components)
    live_h = list(live_h) if live_h is not None else list(gv.h_components)

    chi1inv: Dict[str, Dict[str, Optional[np.ndarray]]] = {}
    cond: Dict[str, Optional[np.ndarray]] = {}
    chi2: Dict[str, Optional[np.ndarray]] = {}
    chi3: Dict[str, Optional[np.ndarray]] = {}
    nr_chi2: Dict[str, Optional[np.ndarray]] = {}

    all_media = [g.material for g in geometry] + [default_material]

    def nontrivial(getter):
        return any(abs(getter(m)) > 0 for m in all_media)

    dind_of = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}

    # ---- epsilon rows on E sites -----------------------------------------
    for c in live_e:
        d_c = G.component_direction(c)
        dind = dind_of[d_c]
        pts = _site_points(gv, c)
        if eps_averaging and geometry:
            offs = _subsample_offsets(gv, subpixel_n)
            mean_eps = mean_inv = None
            # native C++ fast path (meep_nl_tpu.native; the role of the
            # reference's C++ meepgeom rasterization)
            from .. import native as NATIVE
            objs = NATIVE.serialize_objects(geometry)
            if objs is not None and NATIVE.get_lib() is not None:
                eps_of = np.array([tuple(g.material.eps_diag_vec())[dind]
                                   for g in geometry])
                eps_def = tuple(default_material.eps_diag_vec())[dind]
                me, mi = NATIVE.eps_averaged_native(pts, offs, objs, eps_of,
                                                    eps_def)
                mean_eps = me.reshape(gv.shape)
                mean_inv = mi.reshape(gv.shape)
            if mean_eps is None:
                eps_sum = np.zeros(gv.shape)
                inv_sum = np.zeros(gv.shape)
                for off in offs:
                    idx = _material_at(pts + off, geometry, default_material)
                    e = _eps_of(idx, geometry, default_material, dind)
                    eps_sum += e
                    inv_sum += 1.0 / e
                mean_eps = eps_sum / len(offs)
                mean_inv = inv_sum / len(offs)
            # interface normal: analytic per-shape where the surface is
            # known (Sphere/Block/Cylinder/Cone/Ellipsoid/Prism), else the
            # fill-fraction-gradient estimate (signed components: the
            # off-diagonal Kottke terms need n_i n_j with consistent
            # orientation, not just squares)
            grads = [np.gradient(mean_eps, axis=ax)
                     for ax in range(gv.ndim)]
            grad2 = sum(g * g for g in grads)
            gnorm = np.sqrt(np.maximum(grad2, 1e-30))
            nvec = np.zeros(gv.shape + (3,))
            for ax in range(gv.ndim):
                slot = dind_of[gv.axes[ax]]
                nvec[..., slot] = np.where(grad2 > 1e-30,
                                           grads[ax] / gnorm, 0.0)
            an = _analytic_normals(gv, pts, geometry)
            if an is not None:
                have = np.isfinite(an[..., 0])
                nvec = np.where(have[..., None], an, nvec)
            n_own = nvec[..., dind]
            nd2 = n_own * n_own
            # Kottke tensor for isotropic two-material voxels
            # (Kottke-Farjadpour-Johnson 2008; anisotropic_averaging.cpp):
            #   eps_eff^{-1} = <1/eps> nn^T + <eps>^{-1} (I - nn^T)
            # diagonal row entry:
            einv = mean_inv * nd2 + (1.0 / mean_eps) * (1.0 - nd2)
            # off-diagonal row entries (I - nn^T has -n_i n_j off-diag,
            # <1/eps> nn^T has +n_i n_j): (<1/eps> - <eps>^{-1}) n_i n_j.
            # Opt-in via subpixel_tensor=True: tensor-exact at interfaces.
            if subpixel_tensor and gv.dim in ("2d", "3d"):
                delta_inv = mean_inv - 1.0 / mean_eps
                for dd in ("x", "y", "z"):
                    if dd == d_c or (c[0] + dd) not in live_e:
                        continue
                    od = delta_inv * n_own * nvec[..., dind_of[dd]]
                    if np.any(np.abs(od) > 1e-12):
                        chi1inv.setdefault(c, {})[dd] = od
        else:
            idx = _material_at(pts, geometry, default_material)
            einv = 1.0 / _eps_of(idx, geometry, default_material, dind)
        if not np.allclose(einv, 1.0):
            chi1inv.setdefault(c, {})[d_c] = einv

        # full-tensor epsilon: off-diagonal inverse rows (update_eh OFFDIAG
        # path, step_generic.cpp:597). Sampled pointwise (the reference
        # averages subpixel tensors; round 2).
        if any(m.epsilon_offdiag is not None for m in all_media):
            idx_od = _material_at(pts, geometry, default_material)
            full = np.zeros(gv.shape + (3, 3))
            for i, med in enumerate(list(geometry) + [None]):
                mmed = med.material if med is not None else default_material
                diag = tuple(mmed.eps_diag_vec())
                od = (tuple(_v3(mmed.epsilon_offdiag))
                      if mmed.epsilon_offdiag is not None else (0., 0., 0.))
                eps_t = np.array([[diag[0], od[0], od[1]],
                                  [od[0], diag[1], od[2]],
                                  [od[1], od[2], diag[2]]])
                einv_t = np.linalg.inv(eps_t)
                sel = (idx_od == i) if med is not None else (idx_od == -1)
                full[sel] = einv_t
            dind_map = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}
            row = dind_map[d_c]
            chi1inv.setdefault(c, {})[d_c] = full[..., row, row]
            for dd in ("x", "y", "z"):
                if dd == d_c:
                    continue
                col = dind_map[dd]
                if np.any(full[..., row, col] != 0):
                    chi1inv.setdefault(c, {})[dd] = full[..., row, col]

        # pointwise scalars at this site
        idx0 = _material_at(pts, geometry, default_material)
        if nontrivial(lambda m: m.D_conductivity):
            cond["d" + c[1]] = _scalar_of(idx0, geometry, default_material,
                                          lambda m: m.D_conductivity)
        if nontrivial(lambda m: m.chi3):
            chi3[c] = _scalar_of(idx0, geometry, default_material,
                                 lambda m: m.chi3)
            chi2[c] = _scalar_of(idx0, geometry, default_material,
                                 lambda m: 0.0 if m.chi2_full_tensor else m.chi2)
        if nontrivial(lambda m: m.chi2 if m.chi2_full_tensor else 0.0):
            nr_chi2[c] = _scalar_of(idx0, geometry, default_material,
                                    lambda m: m.chi2 if m.chi2_full_tensor else 0.0)

    # ---- mu rows on H sites ------------------------------------------------
    for c in live_h:
        d_c = G.component_direction(c)
        dind = dind_of[d_c]
        if nontrivial(lambda m: m.mu - 1.0):
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            mu = np.full(idx.shape, tuple(default_material.mu_diag_vec())[dind])
            for i, obj in enumerate(geometry):
                v = tuple(obj.material.mu_diag_vec())[dind]
                mu = np.where(idx == i, v, mu)
            chi1inv.setdefault(c, {})[d_c] = 1.0 / mu
        if nontrivial(lambda m: m.B_conductivity):
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            cond["b" + c[1]] = _scalar_of(idx, geometry, default_material,
                                          lambda m: m.B_conductivity)

    # ---- susceptibilities ----------------------------------------------------
    from .geom import (NoisyLorentzianSusceptibility,
                       GyrotropicLorentzianSusceptibility, MultilevelAtom)

    # multilevel atoms are handled separately (their own PolSpec kind)
    ml_pols: List[PolSpec] = []
    for i, obj in enumerate(list(geometry) + [None]):
        med = obj.material if obj is not None else default_material
        for sus in med.E_susceptibilities:
            if not isinstance(sus, MultilevelAtom):
                continue
            Gamma, N0, alpha, omega, gam, sigmat = sus.to_matrices()
            sigma = {}
            for c in live_e:
                d_c = G.component_direction(c)
                pts = _site_points(gv, c)
                idx = _material_at(pts, geometry, default_material)
                sel = (idx == i) if obj is not None else (idx == -1)
                arr = np.where(sel, sus.sigma, 0.0)
                if np.any(arr):
                    sigma[(c, d_c)] = arr
            if sigma:
                ml_pols.append(PolSpec(
                    field_type="e", omega0=float(omega[0]),
                    gamma=float(gam[0]), sigma=sigma, kind="multilevel",
                    ml_Gamma=Gamma, ml_N0=N0, ml_alpha=alpha,
                    ml_omega=omega, ml_gamma=gam, ml_sigmat=sigmat))

    from .geom import GyrotropicSaturatedSusceptibility

    def _kind_of(sus):
        if isinstance(sus, MultilevelAtom):
            return ("multilevel", 0.0, (0.0, 0.0, 0.0), 0.0, False)
        if isinstance(sus, GyrotropicSaturatedSusceptibility):
            # saturated media: the bias sets the axis only
            # (susceptibility.cpp:356 b = bias/|bias|)
            b = np.asarray(tuple(sus.bias), float)
            nb = np.linalg.norm(b)
            if nb == 0:
                raise ValueError(
                    "GyrotropicSaturatedSusceptibility needs a nonzero "
                    "bias axis")
            return ("gyrotropic", 0.0, tuple(b / nb), float(sus.alpha),
                    True)
        if isinstance(sus, GyrotropicLorentzianSusceptibility):
            return ("gyrotropic", 0.0, tuple(sus.bias), 0.0, False)
        if isinstance(sus, NoisyLorentzianSusceptibility):
            return ("noisy", sus.noise_amp, (0.0, 0.0, 0.0), 0.0, False)
        return ("lorentzian", 0.0, (0.0, 0.0, 0.0), 0.0, False)

    pols: List[PolSpec] = []
    sus_keys = {}
    for m in all_media:
        for s in m.E_susceptibilities:
            if isinstance(s, MultilevelAtom):
                continue
            key = (s.frequency, s.gamma, s.drude, "e") + _kind_of(s)
            sus_keys.setdefault(key, []).append((m, s))
        for s in m.H_susceptibilities:
            key = (s.frequency, s.gamma, s.drude, "h") + _kind_of(s)
            sus_keys.setdefault(key, []).append((m, s))
    for (f0, gam, drude, ft, kind, namp, bias, g_alpha,
         g_sat), pairs in sus_keys.items():
        sigma: Dict[Tuple[str, str], np.ndarray] = {}
        live = live_e if ft == "e" else live_h
        for c in live:
            d_c = G.component_direction(c)
            dind = dind_of[d_c]
            pts = _site_points(gv, c)
            idx = _material_at(pts, geometry, default_material)
            arr = np.zeros(gv.shape)
            any_nonzero = False
            for i, obj in enumerate(list(geometry) + [None]):
                med = obj.material if obj is not None else default_material
                sus = (med.E_susceptibilities if ft == "e"
                       else med.H_susceptibilities)
                sv = 0.0
                for s in sus:
                    if (s.frequency, s.gamma, s.drude) == (f0, gam, drude) \
                            and _kind_of(s) == (kind, namp, bias,
                                                g_alpha, g_sat):
                        sv += tuple(s.sigma_vec())[dind]
                if sv != 0.0:
                    any_nonzero = True
                    sel = (idx == i) if obj is not None else (idx == -1)
                    arr = np.where(sel, sv, arr)
            if any_nonzero:
                sigma[(c, d_c)] = arr
        if sigma:
            pols.append(PolSpec(field_type=ft, omega0=f0, gamma=gam,
                                sigma=sigma, drude=drude, kind=kind,
                                noise_amp=namp, bias=bias,
                                gyro_alpha=g_alpha, saturated=g_sat))

    return MaterialSpec(chi1inv=chi1inv, cond=cond, chi2=chi2, chi3=chi3,
                        nr_chi2=nr_chi2, pols=pols + ml_pols)
