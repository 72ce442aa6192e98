"""Slab-stored stepper: the PML aux fields live only on their sigma slabs.

Outside the sigma slabs every uPML chain is the identity (kappa = 1,
sigma = 0), so fu == f and E == u*D inductively (proven exact by
tests/test_slab_opt.py for the slice-based variant).  The uniform stepper
still pays full-array HBM traffic for fu, fw, and the D->E transform;
this mode restructures the state instead:

  * E and H are the ONLY full-size arrays (E = u*D in the interior);
  * D/B exist only as slab pieces on the own-axis W bands (where the
    dsigw chain makes E != u*D);
  * fu exists only as slab pieces on the dsigu-axis bands;
  * fw exists only as slab pieces on the own-axis W bands;

and each half-step reassembles the full field with ONE static
`jnp.concatenate` along the own axis (lo band | interior | hi band) --- a
fresh contiguous buffer, which the uniform path's elementwise update
materializes anyway, so the interior costs the same while all aux traffic
shrinks to the slab fraction.  No dynamic-update-slices (those cost a full
copy wherever XLA does not alias them in place; see Plan.slab_opt).

Chain algebra in E units: with E = u*D and the chains linear diagonal,
  D-form:  D_new = ((kap-sig) D + dfl) siginv
  E-form:  E_new = ((kap-sig) E + u*dfl) siginv        (interior bands)
and likewise the sigu chain with u*(fu_new - fu_old); fu itself stays in
D units so the W bands (which need true D) share the same pieces.

Supported (slab_supported): 3D cartesian, uPML, u (=1/eps) absent or a
per-component constant, no conductivity / dispersion / nonlinearity /
off-diagonal eps / BFAST, sources and DFT monitors on E/H components with
sources outside the PML bands.  Everything else falls back to the
uniform stepper.  Sharding note: the concat axes are the PML axes; under
GSPMD a mesh split along those axes forces resharding, so multi-chip runs
should keep the uniform path (the flag is opt-in).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .plan import Plan
from .step import _curl, _apply_mask, _dft_update


def _vec_bands(vec_kap, vec_sig) -> Tuple[int, int]:
    """(lo_end, hi_start) along the chain axis where the chain is
    non-trivial, measured on the storage-length broadcast vectors (edge
    padding keeps the hi band extended through the dead padding)."""
    kap = np.asarray(vec_kap).ravel()
    sig = np.asarray(vec_sig).ravel()
    live = (sig != 0) | (kap != 1)
    n = len(live)
    lo = 0
    while lo < n and live[lo]:
        lo += 1
    hi = n
    while hi > 0 and live[hi - 1]:
        hi -= 1
    if lo >= hi:
        return (n, n)
    return (lo, hi)


def _scalar_u(plan: Plan, ec: str) -> Optional[float]:
    """The component's u as a scalar, None if u is absent (vacuum), or
    raise ValueError when u varies in space (unsupported here)."""
    key = f"{ec}:u"
    if key not in plan.coefs:
        return None
    u = np.asarray(plan.coefs[key])
    if u.size == 1 or (u.max() == u.min()):
        return float(u.ravel()[0])
    raise ValueError("spatially varying u")


def slab_supported(plan: Plan) -> bool:
    if getattr(plan, 'rot2', None) is not None:
        return False
    if plan.gv.dim != "3d" or plan.bfast_k is not None:
        return False
    if plan.pol_specs_e or plan.pol_specs_h:
        return False
    if plan.have_fmp_e or plan.have_fmp_h:
        return False
    for s in plan.curl_specs_d + plan.curl_specs_b:
        if s.has_cond or s.phi_comp is not None or s.r_weighted:
            return False
    if len(plan.eh_specs_e) != 3 or len(plan.eh_specs_h) != 3:
        return False
    for s in plan.eh_specs_e + plan.eh_specs_h:
        if s.has_u1 or s.has_u2 or s.has_chi3 or s.has_nr:
            return False
        try:
            _scalar_u(plan, s.ec)
        except ValueError:
            return False
    for m in plan.dfts:
        if m.component[0] not in "eh":
            return False
    for s in plan.sources:
        ec = s.component
        if ec[0] not in "eh" or s.is_integrated:
            return False
        key = f"{ec}:kapw"
        if key in plan.coefs:
            spec = next(x for x in (plan.eh_specs_e + plan.eh_specs_h)
                        if x.ec == ec)
            aw = spec.dsigw_axis
            lo, hi = _vec_bands(plan.coefs[key], plan.coefs[f"{ec}:sigw"])
            idx = np.asarray(s.indices)
            if np.any(idx[:, aw] < lo) or np.any(idx[:, aw] >= hi):
                return False
    return True


def _layout(plan: Plan) -> Dict[str, Dict[str, Any]]:
    C = plan.coefs
    curls = {s.c: s for s in plan.curl_specs_d + plan.curl_specs_b}
    out = {}
    for eh in plan.eh_specs_e + plan.eh_specs_h:
        dc, ec = eh.dc, eh.ec
        cs = curls[dc]
        aw = eh.dsigw_axis if f"{ec}:kapw" in C else None
        wlo = whi = None
        if aw is not None:
            wlo, whi = _vec_bands(C[f"{ec}:kapw"], C[f"{ec}:sigw"])
        au = cs.dsigu_axis if f"{dc}:kapu" in C else None
        ulo = uhi = None
        if au is not None:
            ulo, uhi = _vec_bands(C[f"{dc}:kapu"], C[f"{dc}:sigu"])
        has_sig = cs.dsig_axis is not None and f"{dc}:kap" in C
        out[dc] = dict(ec=ec, aw=aw, wlo=wlo, whi=whi, au=au, ulo=ulo,
                       uhi=uhi, has_sig=has_sig, u=_scalar_u(plan, ec))
    return out


def init_state_slab(plan: Plan) -> Dict[str, Any]:
    """State: full E/H arrays + slab pieces for D/B (W bands), fu, fw."""
    from .step import init_state
    base = init_state(plan, _slab_ok=False)
    S = plan.storage_shape
    fdtype = base["f"][next(iter(base["f"]))].dtype
    lay = _layout(plan)

    f = {c: v for c, v in base["f"].items() if c[0] in "eh"}
    d_sl: Dict[str, Any] = {}
    fu_sl: Dict[str, Any] = {}
    fw_sl: Dict[str, Any] = {}
    for dc, L in lay.items():
        if L["aw"] is not None:
            aw, wlo, whi = L["aw"], L["wlo"], L["whi"]
            pd = {}
            if wlo > 0:
                shp = list(S); shp[aw] = wlo
                pd["lo"] = jnp.zeros(shp, fdtype)
            if whi < S[aw]:
                shp = list(S); shp[aw] = S[aw] - whi
                pd["hi"] = jnp.zeros(shp, fdtype)
            if pd:
                d_sl[dc] = pd
                fw_sl[L["ec"]] = {k: jnp.zeros_like(v)
                                  for k, v in pd.items()}
        if L["au"] is not None:
            au, ulo, uhi = L["au"], L["ulo"], L["uhi"]
            pu = {}
            if ulo > 0:
                shp = list(S); shp[au] = ulo
                pu["lo"] = jnp.zeros(shp, fdtype)
            if uhi < S[au]:
                shp = list(S); shp[au] = S[au] - uhi
                pu["hi"] = jnp.zeros(shp, fdtype)
            if pu:
                fu_sl[dc] = pu
    out = {k: v for k, v in base.items()
           if k not in ("f", "f_u", "f_cond", "f_w", "f_bfast")}
    out["f"] = f
    out["d_sl"] = d_sl
    out["fu_sl"] = fu_sl
    out["fw_sl"] = fw_sl
    return out


def _slc(arr, ax, a, b):
    s = [slice(None)] * arr.ndim
    s[ax] = slice(a, b)
    return arr[tuple(s)]


def _half(plan: Plan, lay, S, state, C, ft2: str):
    """One half-step: curl + chains + W bands for the three ft2
    components, in E units on the full arrays and D units on pieces."""
    f = dict(state["f"])
    d_sl = {k: dict(v) for k, v in state["d_sl"].items()}
    fu_sl = {k: dict(v) for k, v in state["fu_sl"].items()}
    fw_sl = {k: dict(v) for k, v in state["fw_sl"].items()}
    specs = plan.curl_specs_d if ft2 == "d" else plan.curl_specs_b

    def vec(key, ax, a, b):
        v = C[key]
        return v if v.shape[ax] == 1 else _slc(v, ax, a, b)

    for cs in specs:
        dc = cs.c
        L = lay[dc]
        ec, u = L["ec"], L["u"]
        aw, wlo, whi = L["aw"], L["wlo"], L["whi"]
        au, ulo, uhi = L["au"], L["ulo"], L["uhi"]
        dfl = _curl(plan, cs, f, C)
        e_old = f[ec]

        def sig_form(f_b, dfl_b, au_a=None, au_b=None):
            if not L["has_sig"]:
                return f_b + dfl_b
            if au_a is None:
                kap, sig, sinv = (C[f"{dc}:kap"], C[f"{dc}:sig"],
                                  C[f"{dc}:siginv"])
            else:
                kap = vec(f"{dc}:kap", au, au_a, au_b)
                sig = vec(f"{dc}:sig", au, au_a, au_b)
                sinv = vec(f"{dc}:siginv", au, au_a, au_b)
            return ((kap - sig) * f_b + dfl_b) * sinv

        # ---- fu pieces (D units, full own axis) ------------------------
        dfu: Dict[str, Tuple[Any, Any]] = {}
        if dc in fu_sl:
            for side, piece in fu_sl[dc].items():
                a, b = (0, ulo) if side == "lo" else (uhi, S[au])
                new = sig_form(piece, _slc(dfl, au, a, b), a, b)
                dfu[side] = (piece, new)
                fu_sl[dc][side] = new

        def region_update(f_band, dfl_band, w_window, e_units):
            """Full inner chain on one own-axis band (concat along au).
            e_units: the band field is E (scale dfl / delta-fu by u)."""
            scale = u if (e_units and u is not None) else None
            dflb = dfl_band * scale if scale is not None else dfl_band
            if dc not in fu_sl:
                return sig_form(f_band, dflb)
            a0, b0 = w_window
            parts = {}
            for side, (old_p, new_p) in dfu.items():
                a, b = (0, ulo) if side == "lo" else (uhi, S[au])
                fo = old_p if aw is None else _slc(old_p, aw, a0, b0)
                fn = new_p if aw is None else _slc(new_p, aw, a0, b0)
                delta = fn - fo
                if scale is not None:
                    delta = delta * scale
                fb = _slc(f_band, au, a, b)
                kapu = vec(f"{dc}:kapu", au, a, b)
                sigu = vec(f"{dc}:sigu", au, a, b)
                sinvu = vec(f"{dc}:siginvu", au, a, b)
                parts[side] = sinvu * ((kapu - sigu) * fb + delta)
            mid = sig_form(_slc(f_band, au, ulo, uhi),
                           _slc(dflb, au, ulo, uhi), ulo, uhi)
            segs = [p for p in (parts.get("lo"), mid, parts.get("hi"))
                    if p is not None]
            return jnp.concatenate(segs, axis=au) if len(segs) > 1 \
                else segs[0]

        if aw is None or dc not in d_sl:
            new_e = region_update(e_old, dfl, (0, S[aw]) if aw is not None
                                  else (None, None), True)
            f[ec] = _apply_mask(plan, C, ec, new_e)
            continue

        segs_e = []
        for side in ("lo", "mid", "hi"):
            if side == "lo":
                if not wlo:
                    continue
                a0, b0 = 0, wlo
            elif side == "hi":
                if whi >= S[aw]:
                    continue
                a0, b0 = whi, S[aw]
            else:
                a0, b0 = wlo, whi
            dfl_b = _slc(dfl, aw, a0, b0)
            if side == "mid":
                segs_e.append(region_update(_slc(e_old, aw, a0, b0),
                                            dfl_b, (a0, b0), True))
                continue
            piece = d_sl[dc][side]
            d_new = region_update(piece, dfl_b, (a0, b0), False)
            d_sl[dc][side] = d_new
            lin = d_new * u if u is not None else d_new
            kapw = vec(f"{ec}:kapw", aw, a0, b0)
            sigw = vec(f"{ec}:sigw", aw, a0, b0)
            fw_old = fw_sl[ec][side]
            segs_e.append(_slc(e_old, aw, a0, b0)
                          + (kapw + sigw) * lin - (kapw - sigw) * fw_old)
            fw_sl[ec][side] = lin
        new_e = jnp.concatenate(segs_e, axis=aw) if len(segs_e) > 1 \
            else segs_e[0]
        f[ec] = _apply_mask(plan, C, ec, new_e)

    return {**state, "f": f, "d_sl": d_sl, "fu_sl": fu_sl, "fw_sl": fw_sl}


def _apply_sources_slab(plan: Plan, lay, C, ft2: str, state, xs):
    """Current sources into the assembled E/H arrays: dD = -J dt maps to
    dE = u dD (sources are restricted to the interior where E = u*D)."""
    f = dict(state["f"])
    dt = plan.dt
    changed = False
    for si, s in enumerate(plan.sources):
        ftc = "d" if s.component[0] == "e" else "b"
        if ftc != ft2 or s.is_integrated:
            continue
        key = f"src{si}:cur_re"
        if key not in xs:
            continue
        ec = s.component
        dc = ft2 + ec[1]
        if dc not in lay:
            continue
        w_re, w_im = xs[key], xs[f"src{si}:cur_im"]
        a_re, a_im = C[f"src{si}:amp_re"], C[f"src{si}:amp_im"]
        if plan.complex_fields:
            A = (w_re + 1j * w_im) * (a_re + 1j * a_im) * dt
        else:
            A = (w_re * a_re - w_im * a_im) * dt
        u = lay[dc]["u"]
        if u is not None:
            A = A * u
        idx = C[f"src{si}:idx"]
        f[ec] = f[ec].at[tuple(idx.T)].add(-A)
        changed = True
    return {**state, "f": f} if changed else state


def make_step_slab(plan: Plan):
    """The slab-stored step function (see module docstring)."""
    lay = _layout(plan)
    S = plan.storage_shape

    def step(state: Dict[str, Any], xs: Dict[str, Any],
             C: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if C is None:
            C = plan.coefs
        state = _half(plan, lay, S, state, C, "b")
        state = _apply_sources_slab(plan, lay, C, "b", state, xs)
        state = _half(plan, lay, S, state, C, "d")
        state = _apply_sources_slab(plan, lay, C, "d", state, xs)
        state = {**state, "t": state["t"] + 1}
        return _dft_update(plan, C, state, xs)

    return step
