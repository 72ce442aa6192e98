"""The fused FDTD timestep as a pure `state -> state` function.

Array re-design of the reference's stepping core, compiled by XLA:
  * fields::step ordering          -> `make_step` (step.cpp:35-140)
  * step_curl + PML/cond chain     -> `_curl_update` (step_generic.cpp:69-253)
  * step_update_EDHB               -> `_eh_update` (step_generic.cpp:576-906)
  * Pade Kerr factor               -> `_nonlinear_u` (step_generic.cpp:546)
  * fork's chi2 Newton-Raphson     -> `_nr_solve` (newton_raphson.cpp:93,
                                      step_generic.cpp:732-815), recast as a
                                      fixed-iteration vectorized Newton with a
                                      closed-form 3x3 solve, masked on chi2!=0
  * lorentzian_susceptibility::update_P -> `_pol_update`
                                      (susceptibility.cpp:188-260)
  * dft_chunk::update_dft          -> `_dft_update` (dft.cpp:265-306)
  * step_source                    -> `_apply_sources` (step.cpp:296-319)

All branching is resolved at trace time from the static Plan; the resulting
function is scan- and grad-compatible.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import grid as G
from ..ops.stencil import shift
from .plan import Plan, CurlSpec, EhSpec, PolSpec, SrcVolSpec, DftSpec


def _is_pair(plan: Plan) -> bool:
    """Real-pair complex mode: complex fields stored as a leading (re, im)
    channel axis, all compute in real arithmetic (cf. fields.cpp DOCMP
    loops, which the reference unrolls the same way)."""
    return bool(getattr(plan, "real_pair", False))


def _sh(plan: Plan, arr, axis: int, by: int):
    """Plan-bound shift: PEC zero-fill or Bloch wrap with the live extent.

    `axis` is the GRID axis; arrays may carry leading batch/channel dims
    (the real-pair channel, multilevel transition stacks), offset here."""
    off = arr.ndim - plan.gv.ndim
    pair = _is_pair(plan) and off == 1
    return shift(arr, axis + off, by, plan.periodic[axis],
                 plan.bloch_phase[axis], nlive=plan.gv.num[axis], pair=pair)


def _pair_cmul(arr, re: float, im: float):
    """Multiply a channel-stacked pair by the complex scalar re + i*im."""
    return jnp.stack([re * arr[0] - im * arr[1],
                      im * arr[0] + re * arr[1]])


def _apply_mask(plan: Plan, C: Dict[str, Any], c: str, arr):
    """Enforce the metal/axis/dead-padding mask (boundaries.cpp:304
    zero_metal analog).

    When the mask is a set of axis-aligned dead planes (the common case),
    they are zeroed by per-axis iota-compare multiplies (default) or by
    thin dynamic-update-slices (opt-in via plan.plane_masks; whether XLA
    aliases those in place inside the scan carry decides which is
    cheaper)."""
    planes = plan.mask_planes.get(c) if plan.mask_planes else None
    if planes is None:
        return arr * C[f"mask:{c}"]
    off = arr.ndim - plan.gv.ndim            # leading channel/batch dims
    if getattr(plan, "plane_masks", False):
        # thin dynamic-update-slices: opt-in (aliasing caveat above)
        for ax, i in planes:
            idx = [slice(None)] * arr.ndim
            idx[ax + off] = i
            arr = arr.at[tuple(idx)].set(0.0)
        return arr
    # default: per-axis iota-compare masks.  The alive vectors are 1D
    # (broadcast at use), so XLA generates them in-register: unlike the
    # full mask-array multiply this costs ZERO HBM reads (the mask arrays
    # were ~20% of the step's traffic), and unlike the DUS mode it
    # introduces no aliasing hazard in scan carries.
    by_ax: Dict[int, list] = {}
    for ax, i in planes:
        by_ax.setdefault(ax, []).append(i)
    for ax, idxs in by_ax.items():
        n = arr.shape[ax + off]
        io = jax.lax.iota(jnp.int32, n)
        alive = jnp.ones((n,), bool)
        for i in idxs:
            alive = alive & (io != i)
        shape = [1] * arr.ndim
        shape[ax + off] = n
        arr = arr * alive.astype(arr.dtype).reshape(shape)
    return arr

def _nr_iters() -> int:
    """Newton iteration count, read lazily so MNT_NR_ITERS set after
    import is honored at the next trace (already-jitted runners keep
    their baked count — clear jit caches to re-trace).

    Newton from the PERTURBATIVE seed (error O(r^2) in r = chi2 E/eps,
    the relative NL correction) contracts quadratically: after k steps
    the error is ~ r^(2^(k+1)).  Even at r = 0.3 — far beyond the
    perturbative regime where chi2 FDTD is meaningful — 3 steps give
    r^16 ~ 4e-9, below fp32 roundoff (the reference iterates adaptively
    to 1e-8, newton_raphson.cpp:30; a fixed count keeps the step
    branchless).  Gated by test_nonlinear.py::test_nr_iteration_margin
    (3 vs 24 iterations agree to fp32 roundoff on the SHG config);
    MNT_NR_ITERS overrides for stronger-than-physical chi2."""
    return int(os.environ.get("MNT_NR_ITERS", "3"))


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init_state(plan: Plan, _slab_ok: bool = True) -> Dict[str, Any]:
    if _slab_ok and getattr(plan, "slab_store", False):
        from .slabstep import slab_supported, init_state_slab
        if slab_supported(plan):
            return init_state_slab(plan)
    gv = plan.gv
    pair = _is_pair(plan) and plan.complex_fields
    fdtype = jnp.complex64 if plan.complex_fields else plan.dtype
    if plan.dtype == np.float64:
        fdtype = jnp.complex128 if plan.complex_fields else jnp.float64
    base_shape = tuple(plan.storage_shape or gv.shape)
    if pair:
        # real-pair complex storage: leading (re, im) channel axis, real
        # dtype — every update stays in real arithmetic (the reference's
        # DOCMP unroll, fields.cpp)
        fdtype = plan.dtype
        shape = (2,) + base_shape
        for p in plan.pol_specs_e + plan.pol_specs_h:
            if p.kind == "multilevel":
                raise NotImplementedError(
                    "multilevel atoms with real-pair complex fields")
        for s in plan.eh_specs_e + plan.eh_specs_h:
            if s.has_chi3 or s.has_nr:
                raise NotImplementedError(
                    "nonlinear media require real fields (as in the "
                    "reference)")
    else:
        shape = base_shape

    def zeros():
        return jnp.zeros(shape, dtype=fdtype)

    f: Dict[str, Any] = {}
    for spec in plan.curl_specs_d + plan.curl_specs_b:
        f[spec.c] = zeros()
    for spec in plan.eh_specs_e + plan.eh_specs_h:
        f[spec.ec] = zeros()

    f_u = {s.c: zeros() for s in plan.curl_specs_d + plan.curl_specs_b
           if s.dsigu_axis is not None}
    f_cond = {s.c: zeros() for s in plan.curl_specs_d + plan.curl_specs_b
              if (s.dsig_axis is not None and s.has_cond)}
    f_w = {s.ec: zeros() for s in plan.eh_specs_e + plan.eh_specs_h
           if s.dsigw_axis is not None}
    f_bfast = {}
    if plan.bfast_k is not None:
        f_bfast = {s.c: zeros()
                   for s in plan.curl_specs_d + plan.curl_specs_b}

    pol = []
    for pi, p in enumerate(plan.pol_specs_e + plan.pol_specs_h):
        comps = sorted({c for (c, d) in p.sigma if d == G.component_direction(c)})
        entry = {
            "p": {c: zeros() for c in comps},
            "pp": {c: zeros() for c in comps},
        }
        if p.kind == "multilevel":
            # per-transition P stacks and centered-lattice populations
            # (multilevel_data, multilevel-atom.cpp:240)
            T = len(p.ml_omega)
            L = len(p.ml_N0)
            N0 = jnp.asarray(np.asarray(p.ml_N0, np.float64),
                             plan.dtype).reshape((L,) + (1,) * len(shape))
            entry = {
                "p": {c: jnp.zeros((T,) + tuple(shape), dtype=fdtype)
                      for c in comps},
                "pp": {c: jnp.zeros((T,) + tuple(shape), dtype=fdtype)
                       for c in comps},
                "N": jnp.tile(N0, (1,) + tuple(shape)),
            }
            pol.append(entry)
            continue
        if p.kind == "gyrotropic":
            # gyrotropic media track the full P 3-vector at every component
            # site (gyrotropy_data, susceptibility.cpp:445); the off-axis
            # entries are carried under '#' keys (skipped by subtract_P)
            for c in comps:
                entry["p"][f"{c}#1"] = zeros()
                entry["p"][f"{c}#2"] = zeros()
                entry["pp"][f"{c}#1"] = zeros()
                entry["pp"][f"{c}#2"] = zeros()
        pol.append(entry)

    dft = {}
    for m in plan.dfts:
        ext = tuple(b - a for a, b in m.region)
        # real (re, im) pair storage: the in-scan accumulators and their
        # updates stay entirely real; consumers go through dft_view()
        dft[m.name] = jnp.zeros(ext + (len(m.freqs), 2),
                                dtype=jnp.float32
                                if plan.dtype != np.float64 else jnp.float64)

    out = {"f": f, "f_u": f_u, "f_cond": f_cond, "f_w": f_w,
           "pol": pol, "dft": dft, "t": jnp.zeros((), jnp.int32)}
    if f_bfast:
        out["f_bfast"] = f_bfast
    # W_prev needed by multilevel atoms (needs_W_prev, update_eh.cpp:222)
    mlw = set()
    for p in plan.pol_specs_e + plan.pol_specs_h:
        if p.kind == "multilevel":
            for (c, d) in p.sigma:
                mlw.add(c)
    if mlw:
        out["f_w_prev"] = {c: jnp.zeros(shape, dtype=fdtype) for c in mlw}
    if any(p.kind == "noisy"
           for p in plan.pol_specs_e + plan.pol_specs_h):
        out["rng"] = jax.random.PRNGKey(plan_seed(plan))
    return out


def plan_seed(plan) -> int:
    """Deterministic RNG seed (set_random_seed analog, src/random.cpp)."""
    return getattr(plan, "_rng_seed", 12345)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _mirror_node_ghost(plan: Plan, g: jnp.ndarray, gname: str,
                       ax: int, d_letter: str, phase: int) -> jnp.ndarray:
    """Mirror-fold ghost plane for a backward difference across a
    NODE-aligned mirror plane at site 0 (vec.hpp:1189 mirror_symmetry;
    symmetry planes on whole grid sites arise for phase=+1 on even cell
    counts, e.g. the reference's default (make mirror-sym ...) cells):

        f_g(-x) = phase * P_g(d) * f_g(+x)

    with P_g the vector/pseudovector parity (E_d, H_t odd; E_t, H_d
    even).  The reflected source plane is index 1 - yee_shift for
    node components and 0 for half-offset ones (their first site sits
    at +dx/2, reflecting onto -dx/2)."""
    gv = plan.gv
    off = g.ndim - gv.ndim
    ys = G.yee_shift(gname, gv.dim)
    if gname[0] in ("e", "d"):
        s = float(phase) * (-1.0 if gname[1] == d_letter else 1.0)
    else:
        s = float(phase) * (1.0 if gname[1] == d_letter else -1.0)
    k0 = 1 - ys[d_letter]
    sl = [slice(None)] * g.ndim
    sl[ax + off] = slice(k0, k0 + 1)
    return s * g[tuple(sl)]


def _rot2_ghost(plan: Plan, g: jnp.ndarray, gname: str) -> jnp.ndarray:
    """The C2-fold ghost plane for a backward difference across the
    rotation-axis plane at fold-axis site 0 (vec.hpp:1189-1232 rotate2):

        f_g(-x0, -y, .) = S_g * f_g(x0, -(-y), .)

    with S_g = phase * (+1 if g points along the rotation axis else -1)
    (proper rotation: E and H transform identically), x0 the reflected
    source plane (index 1 for fold-offset-0 comps, 0 for offset-1/2),
    and the flip running over the live flip-axis extent (offset-aware)."""
    fold_ax, flip_ax, w_letter, phase = plan.rot2
    gv = plan.gv
    off = g.ndim - gv.ndim
    ys = G.yee_shift(gname, gv.dim)
    s = float(phase) * (1.0 if gname[1] == w_letter else -1.0)
    k0 = 1 - ys[gv.axes[fold_ax]]        # reflected source plane index
    axf, axl = fold_ax + off, flip_ax + off
    sl = [slice(None)] * g.ndim
    sl[axf] = slice(k0, k0 + 1)
    plane = g[tuple(sl)]
    nl = gv.num[flip_ax] + (1 if ys[gv.axes[flip_ax]] == 0 else 0)
    liv = [slice(None)] * g.ndim
    liv[axl] = slice(0, nl)
    rev = jnp.flip(plane[tuple(liv)], axis=axl)
    if plane.shape[axl] > nl:
        pad = [(0, 0)] * g.ndim
        pad[axl] = (0, plane.shape[axl] - nl)
        rev = jnp.pad(rev, pad)
    return s * rev


def _rot4_ghost(plan: Plan, f: Dict[str, Any], gname: str,
                a: int) -> jnp.ndarray:
    """The C4-fold ghost plane for a backward difference across fold
    plane `a` (one of the two perpendicular axes) at site 0
    (vec.hpp:1189-1232 rotate4).  With R the +90-degree rotation taking
    ax1 into ax2, the symmetry F(R r) = p rho(R) F(r) gives the ghost as
    a DIRECT (unflipped) transposed read of the x<->y-swapped component
    at the reflected source row:

        ax1-ghost:  g(-x0, y, .) = s * g'(y, +x0', .)
        ax2-ghost:  g(x, -y0, .) = s * g'(+y0', x, .)

    with g' = swap_{ax1<->ax2}(g), row index 1 - yee_shift(g, fold
    letter), and s from the rotation matrix: for the ax1 ghost
    (F_ax1, F_ax2, F_w) pick up (-p, +p, +p); for the ax2 ghost
    (+p, -p, +p) — E and H transform identically (proper rotation)."""
    ax1, ax2, w_letter, phase = plan.rot4
    gv = plan.gv
    l1, l2 = gv.axes[ax1], gv.axes[ax2]
    swap = {l1: l2, l2: l1}
    g2name = gname[0] + swap.get(gname[1], gname[1])
    g2 = f[g2name]
    off = g2.ndim - gv.ndim
    ys = G.yee_shift(gname, gv.dim)
    if gname[1] == w_letter:
        s = float(phase)
    elif (gname[1] == l1) == (a == ax1):
        s = -float(phase)
    else:
        s = float(phase)
    fold_letter = l1 if a == ax1 else l2
    k0 = 1 - ys[fold_letter]              # reflected source row in g'
    other = ax2 if a == ax1 else ax1
    sl = [slice(None)] * g2.ndim
    sl[other + off] = slice(k0, k0 + 1)
    plane = g2[tuple(sl)]                 # row at the reflected index
    # transpose the in-plane axes: the ghost's `other`-axis index is the
    # read's `a`-axis index (square wedge: the two extents match)
    return s * jnp.swapaxes(plane, a + off, other + off)


def _curl(plan: Plan, spec: CurlSpec, f: Dict[str, Any],
          C: Optional[Dict[str, Any]] = None) -> jnp.ndarray:
    """dfl such that the no-PML update is f += dfl (step_generic.cpp:39-67).

    D components: +Courant * (bwd-diff g_plus - bwd-diff g_minus)
    B components: -Courant * (fwd-diff g_plus - fwd-diff g_minus)

    Cylindrical (step_db.cpp:86-294): phi-derivatives become i*m/r
    multiplies; the z component's radial derivative is (1/r) d(r g)/dr.
    """
    dtdx = plan.courant

    def set_plane0(sh, ax, ghost):
        """Write the (size-1) ghost onto plane 0 along `ax`."""
        osl = [slice(None)] * sh.ndim
        osl[ax] = slice(0, 1)
        return sh.at[tuple(osl)].set(ghost)

    def diff(g, a, gname=None):
        if spec.is_d:   # backward difference
            sh = _sh(plan, g, a, -1)
            if plan.mirror_node and gname is not None:
                for (max_, md, mp_) in plan.mirror_node:
                    if max_ == a:
                        off = g.ndim - plan.gv.ndim
                        sh = set_plane0(sh, a + off, _mirror_node_ghost(
                            plan, g, gname, max_, md, mp_))
            if plan.rot2 is not None and a == plan.rot2[0] \
                    and gname is not None:
                off = g.ndim - plan.gv.ndim
                sh = set_plane0(sh, a + off, _rot2_ghost(plan, g, gname))
            if plan.rot4 is not None and a in plan.rot4[:2] \
                    and gname is not None:
                off = g.ndim - plan.gv.ndim
                sh = set_plane0(sh, a + off,
                                _rot4_ghost(plan, f, gname, a))
            return g - sh
        return _sh(plan, g, a, +1) - g  # forward difference

    sgn = 1.0 if spec.is_d else -1.0
    total = None
    if spec.g_plus is not None:
        if spec.r_weighted:
            # (1/r) d(r g)/dr discretized on the staggered lattice
            rg = C[f"{spec.c}:rg"] * f[spec.g_plus]
            total = C[f"{spec.c}:rfinv"] * diff(rg, spec.plus_axis)
        else:
            total = diff(f[spec.g_plus], spec.plus_axis, spec.g_plus)
    if spec.g_minus is not None:
        t2 = diff(f[spec.g_minus], spec.minus_axis, spec.g_minus)
        total = -t2 if total is None else total - t2
    out = 0.0 if total is None else sgn * dtdx * total
    if spec.phi_comp is not None and (plan.m != 0 or plan.beta != 0.0):
        # i*m/r phi-derivative term (cylindrical) or the constant i*beta
        # out-of-plane coupling (2D special_kz); the sign carries the
        # curl slot and the D/B orientation like the finite-difference
        # terms
        if _is_pair(plan):
            term = C[f"{spec.c}:imr"] * _pair_cmul(
                f[spec.phi_comp], 0.0, spec.phi_sign * sgn * dtdx)
        else:
            term = (1j * spec.phi_sign * sgn * dtdx) * C[f"{spec.c}:imr"] \
                * f[spec.phi_comp]
        out = out + term
    return out


def _slab_slices(slabs, axis: int, n_sites: int, ndim: int):
    """Storage slices of the lo/hi sigma slabs along `axis`."""
    lo, hi = slabs
    out = []
    if lo > 0:
        sl = [slice(None)] * ndim
        sl[axis] = slice(0, lo)
        out.append(tuple(sl))
    if hi > 0:
        sl = [slice(None)] * ndim
        sl[axis] = slice(n_sites - hi, n_sites)
        out.append(tuple(sl))
    return out


def _curl_update(plan: Plan, C: Dict[str, Any], spec: CurlSpec,
                 state: Dict[str, Any]) -> Dict[str, Any]:
    """The full PML/conductivity chain around a curl delta
    (step_generic.cpp:89-253).

    chain: dfl -> [cond: fcnd aux] -> [dsig: f or fu] -> [dsigu: f].
    When slab_opt applies (no conductivity), the chains run only on the
    sigma slabs: outside them kappa=1/sigma=0 makes the chain the identity
    and fu==f inductively, so the full-array aux traffic is skipped."""
    c = spec.c
    f = state["f"][c]
    dfl = _curl(plan, spec, state["f"], C)
    dt = plan.dt
    new_state = state

    has_sig = spec.dsig_axis is not None
    has_sigu = spec.dsigu_axis is not None
    has_cond = spec.has_cond

    slab_ok = (plan.slab_opt and not has_cond and not _is_pair(plan)
               and (not has_sig or spec.dsig_slabs is not None)
               and (not has_sigu or spec.dsigu_slabs is not None)
               and (has_sig or has_sigu))
    if slab_ok:
        ndim = f.ndim
        base = f + dfl
        if has_sig:
            n_sites = plan.gv.num[spec.dsig_axis] + 1
            for sl in _slab_slices(spec.dsig_slabs, spec.dsig_axis,
                                   n_sites, ndim):
                ksl = tuple(s if C[f"{c}:kap"].shape[i] > 1 else slice(None)
                            for i, s in enumerate(sl))
                base = base.at[sl].set(
                    ((C[f"{c}:kap"][ksl] - C[f"{c}:sig"][ksl]) * f[sl]
                     + dfl[sl]) * C[f"{c}:siginv"][ksl])
        if has_sigu:
            fu_full = state["f_u"][c]
            n_sites = plan.gv.num[spec.dsigu_axis] + 1
            new_fu = fu_full
            for sl in _slab_slices(spec.dsigu_slabs, spec.dsigu_axis,
                                   n_sites, ndim):
                kusl = tuple(s if C[f"{c}:kapu"].shape[i] > 1 else slice(None)
                             for i, s in enumerate(sl))
                fu_old = fu_full[sl]
                # inner chain on this slab (includes the dsig chain where
                # the slabs intersect, via the sliced vectors)
                if has_sig:
                    ksl2 = tuple(s if C[f"{c}:kap"].shape[i] > 1
                                 else slice(None) for i, s in enumerate(sl))
                    fu_new = ((C[f"{c}:kap"][ksl2] - C[f"{c}:sig"][ksl2])
                              * fu_old + dfl[sl]) * C[f"{c}:siginv"][ksl2]
                else:
                    fu_new = fu_old + dfl[sl]
                base = base.at[sl].set(
                    C[f"{c}:siginvu"][kusl]
                    * ((C[f"{c}:kapu"][kusl] - C[f"{c}:sigu"][kusl]) * f[sl]
                       + fu_new - fu_old))
                new_fu = new_fu.at[sl].set(fu_new)
            new_state = {**new_state, "f_u": {**state["f_u"], c: new_fu}}
        f_new = _apply_mask(plan, C, c, base)
        return {**new_state, "f": {**new_state["f"], c: f_new}}

    if has_sig and has_cond:
        fcnd = state["f_cond"][c]
        fcnd_new = ((1 - 0.5 * dt * C[f"{c}:cnd"]) * fcnd + dfl) * C[f"{c}:cndinv"]
        delta = fcnd_new - fcnd
        new_state = {**new_state, "f_cond": {**state["f_cond"], c: fcnd_new}}
    elif has_cond:
        # conductivity applied directly to the innermost field below
        delta = dfl
    else:
        delta = dfl

    def inner_update(g):
        """Update of the innermost field (f or fu) with delta."""
        if has_sig:
            return ((C[f"{c}:kap"] - C[f"{c}:sig"]) * g + delta) * C[f"{c}:siginv"]
        if has_cond:
            return ((1 - 0.5 * dt * C[f"{c}:cnd"]) * g + delta) * C[f"{c}:cndinv"]
        return g + delta

    if has_sigu:
        fu = state["f_u"][c]
        fu_new = inner_update(fu)
        f_new = C[f"{c}:siginvu"] * ((C[f"{c}:kapu"] - C[f"{c}:sigu"]) * f
                                     + fu_new - fu)
        new_state = {**new_state, "f_u": {**new_state["f_u"], c: fu_new}}
    else:
        f_new = inner_update(f)

    f_new = f_new * C[f"mask:{c}"]
    new_state = {**new_state, "f": {**new_state["f"], c: f_new}}
    return new_state


def _bfast_update(plan: Plan, C: Dict[str, Any], spec: CurlSpec,
                  state: Dict[str, Any]) -> Dict[str, Any]:
    """BFAST fixed-angle broadband terms (the fork's step_bfast,
    step_generic.cpp:339-537).

    The flip-flop auxiliary F implements multiplication by i*tan(w dt/2),
    i.e. an effective k_x(w) = scaled_k * w --- frequency-proportional
    transverse wavevector, which is what makes oblique incidence broadband
    at a FIXED angle.  F_new = (k1*pair(g1) - k2*pair(g2)) - F_prev;
    f += (F_new - F_prev) through the conductivity/PML chains (additive,
    like step_beta)."""
    if plan.bfast_k is None:
        return state
    kidx = {"x": 0, "y": 1, "z": 2}
    # each slot's k is the scaled-k component along that term's
    # DIFFERENTIATION axis (ik_ax replaces d/d ax); equivalent to the
    # reference's cross-product partner-letter assignment when both curl
    # partners exist (step_db.cpp:129-137).  Like the reference, apply
    # BFAST only to two-partner curls: the fork's supported mode is the
    # 3D-component 1D/3D cell (test_refl_angular.py), where every curl has
    # both partners; activating single-partner terms (2D TM) destabilizes
    # the flip-flop even below the BFAST CFL bound.
    if spec.g_plus is None or spec.g_minus is None:
        return state
    axes = plan.gv.axes
    k1 = plan.bfast_k[kidx[axes[spec.plus_axis]]]
    k2 = plan.bfast_k[kidx[axes[spec.minus_axis]]]
    if spec.is_d:
        k1, k2 = -k1, -k2
    if (k1 == 0.0 or spec.g_plus is None) and \
            (k2 == 0.0 or spec.g_minus is None):
        return state
    c = spec.c

    def pair(g, a):
        if spec.is_d:
            return g + _sh(plan, g, a, -1)
        return _sh(plan, g, a, +1) + g

    f = state["f"]
    A = 0.0
    if spec.g_plus is not None and k1 != 0.0:
        A = A + k1 * pair(f[spec.g_plus], spec.plus_axis)
    if spec.g_minus is not None and k2 != 0.0:
        A = A - k2 * pair(f[spec.g_minus], spec.minus_axis)
    if f"{c}:bftap" in C:
        A = A * C[f"{c}:bftap"]
    F_prev = state["f_bfast"][c]
    # In lossy regions (PML sigma / conductivity) the bare flip-flop
    # F_new = A - F_prev is destabilized by the field-aux feedback loop
    # (measured growth 1.014/step localized in the PML skin even at the
    # BFAST-reduced Courant), because F's Nyquist pole sits exactly on the
    # unit circle while the fields it couples to decay.  Damp F with the
    # same per-site decay factor the fields see, gamma = (kap-sig)/(kap+sig)
    # (and the conductivity equivalent): identically 1 in the interior, so
    # the dispersion there is untouched; inside absorbing layers the
    # effective k_x rolls off with the fields (a small extra PML
    # reflection, traded for unconditional stability).
    gam = None

    def mulgam(g, extra):
        return extra if g is None else g * extra

    if spec.dsig_axis is not None:
        gam = mulgam(gam, (C[f"{c}:kap"] - C[f"{c}:sig"])
                     * C[f"{c}:siginv"])
    if spec.dsigu_axis is not None:
        gam = mulgam(gam, (C[f"{c}:kapu"] - C[f"{c}:sigu"])
                     * C[f"{c}:siginvu"])
    if spec.has_cond:
        gam = mulgam(gam, (1 - 0.5 * plan.dt * C[f"{c}:cnd"])
                     * C[f"{c}:cndinv"])
    if gam is None:
        # chain-free components (e.g. dz in z-PML): key off the partner
        # E/H component's own-direction W-chain profile when present
        ec = ("e" if c[0] == "d" else "h") + c[1]
        if f"{ec}:sigw" in C:
            gam = (C[f"{ec}:kapw"] - C[f"{ec}:sigw"]) \
                / (C[f"{ec}:kapw"] + C[f"{ec}:sigw"])
    F_new = (A - (gam * F_prev if gam is not None else F_prev))
    delta = F_new - F_prev
    new_state = {**state, "f_bfast": {**state["f_bfast"], c: F_new}}
    if spec.has_cond:
        delta = delta * C[f"{c}:cndinv"]
        if spec.dsig_axis is not None and c in new_state["f_cond"]:
            # conductivity+PML: the recurrence integrates through fcnd
            # (step_generic.cpp:489 dfcnd bookkeeping); without PML the
            # conductivity is folded into the inner update directly
            fcnd = new_state["f_cond"][c]
            new_state = {**new_state,
                         "f_cond": {**new_state["f_cond"], c: fcnd + delta}}
    if spec.dsig_axis is not None:
        delta = delta * C[f"{c}:siginv"]
    if spec.dsigu_axis is not None:
        fu = new_state["f_u"][c]
        new_state = {**new_state, "f_u": {**new_state["f_u"], c: fu + delta}}
        delta = delta * C[f"{c}:siginvu"]
    fc = _apply_mask(plan, C, c, f[c] + delta)
    return {**new_state, "f": {**f, c: fc}}


def _nonlinear_u(Dsqr, Di, u, chi2, chi3):
    """Pade approximant for the Kerr/chi2 scalar inversion
    (step_generic.cpp:546 calc_nonlinear_u)."""
    c2 = Di * chi2 * (u * u)
    c3 = Dsqr * chi3 * (u * u * u)
    return (1 + c2 + 2 * c3) / (1 + 2 * c2 + 3 * c3)


def _offdiag(plan, u1, g1, ax1, ax_own, sgn):
    """OFFDIAG(u,g,sx) of step_generic.cpp:597: stable Yee average of an
    off-diagonal chi1inv row against the partner D component."""
    t = (g1 + _sh(plan, g1, ax1, -sgn)) * u1
    return 0.25 * (t + _sh(plan, t, ax_own, sgn))


def _avg4(plan, g, ax_own, ax_off, sgn):
    """gs_2-style neighbor average (step_generic.cpp:740)."""
    g_s = _sh(plan, g, ax_own, sgn)
    g_x = _sh(plan, g, ax_off, -sgn)
    g_sx = _sh(plan, g_s, ax_off, -sgn)
    return 0.25 * (g + g_s + g_x + g_sx)


def _sum4(plan, g, ax_own, ax_off, sgn):
    g_s = _sh(plan, g, ax_own, sgn)
    g_x = _sh(plan, g, ax_off, -sgn)
    g_sx = _sh(plan, g_s, ax_off, -sgn)
    return g + g_s + g_x + g_sx


def _nr_solve(A_own, A_1, A_2, eps, chi2, seed_own, seed_1, seed_2):
    """Vectorized Newton for the zinc-blende chi2 system
    (newton_raphson.cpp:144 `equations`):

        A_own = eps*x + chi2*y*z
        A_1   = eps*y + chi2*x*z
        A_2   = eps*z + chi2*x*y

    Fixed _nr_iters() Newton iterations with an analytic 3x3 solve from a
    FIRST-ORDER PERTURBATIVE seed; replaces the reference's
    data-dependent loop (<=500 iters, tol 1e-8) with a branchless
    form.  The seed x0 = (A - chi2 y0 z0)/eps (y0/z0 the
    linear values) has error O(r^2) in r = chi2 E/eps, so with the
    quadratic Newton contraction e_{k+1} ~ e_k^2 the default THREE
    iterations reach r^16 — the same guarantee the previous linear-seed
    4-iteration default had, one 3x3 solve cheaper.  Where chi2 == 0,
    returns the linear seed.
    """
    # perturbative seed (one multiply-chain per component)
    ueff = 1.0 / jnp.where(eps == 0, 1.0, eps)
    sx = A_own * ueff
    sy = A_1 * ueff
    sz = A_2 * ueff
    cu = chi2 * ueff
    x = sx - cu * sy * sz
    y = sy - cu * sx * sz
    z = sz - cu * sx * sy
    aa = eps * eps                    # loop-invariant

    def body(i, xyz):
        x, y, z = xyz
        F1 = A_own - (eps * x + chi2 * y * z)
        F2 = A_1 - (eps * y + chi2 * x * z)
        F3 = A_2 - (eps * z + chi2 * x * y)
        # J = -[[eps, c*z, c*y], [c*z, eps, c*x], [c*y, c*x, eps]]
        a, b_, c_, d_ = eps, chi2 * z, chi2 * y, chi2 * x
        # solve J * delta = F with J = -M, M symmetric:
        # M = [[a, b, c], [b, a, d], [c, d, a]]
        b2, c2, d2 = b_ * b_, c_ * c_, d_ * d_
        det = a * (aa - b2 - c2 - d2) + 2.0 * (b_ * c_ * d_)
        det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
        rdet = 1.0 / det               # one reciprocal, three multiplies
        i00 = aa - d2
        i01 = c_ * d_ - b_ * a
        i02 = b_ * d_ - c_ * a
        i11 = aa - c2
        i12 = c_ * b_ - a * d_
        i22 = aa - b2
        dx = (i00 * F1 + i01 * F2 + i02 * F3) * rdet
        dy = (i01 * F1 + i11 * F2 + i12 * F3) * rdet
        dz = (i02 * F1 + i12 * F2 + i22 * F3) * rdet
        # delta solves M delta = -F ; J = -M  =>  x -= J^-1 F  == x += M^-1 F
        return (x + dx, y + dy, z + dz)

    x, y, z = jax.lax.fori_loop(0, _nr_iters(), body, (x, y, z))
    live = chi2 != 0
    return (jnp.where(live, x, seed_own),
            jnp.where(live, y, seed_1),
            jnp.where(live, z, seed_2))


def _eh_update(plan: Plan, C: Dict[str, Any], spec: EhSpec,
               state: Dict[str, Any], dmp: Dict[str, Any]) -> Dict[str, Any]:
    """E = chi1inv*(D - P) with off-diagonal averaging, Kerr Pade, the NR chi2
    branch, and the PML W chain (step_generic.cpp:576-906)."""
    ec = spec.ec
    sgn = 1 if ec[0] == "e" else -1  # H strides negated (update_eh.cpp:192)

    gs = dmp[spec.dc]
    us = C[f"{ec}:u"] if spec.has_u else None

    lin = gs * us if us is not None else gs
    if spec.has_u1:
        g1 = dmp[spec.dc1]
        lin = lin + _offdiag(plan, C[f"{ec}:u1"], g1, spec.ax_1, spec.ax_own, sgn)
    if spec.has_u2:
        g2 = dmp[spec.dc2]
        lin = lin + _offdiag(plan, C[f"{ec}:u2"], g2, spec.ax_2, spec.ax_own, sgn)

    if spec.has_chi3:
        u_for_nl = us if us is not None else 1.0
        Dsqr = gs * gs
        if spec.dc1 is not None and spec.ax_1 is not None:
            g1s = _sum4(plan, dmp[spec.dc1], spec.ax_own, spec.ax_1, sgn)
            Dsqr = Dsqr + 0.0625 * (g1s * g1s)
        if spec.dc2 is not None and spec.ax_2 is not None:
            g2s = _sum4(plan, dmp[spec.dc2], spec.ax_own, spec.ax_2, sgn)
            Dsqr = Dsqr + 0.0625 * (g2s * g2s)
        lin = lin * _nonlinear_u(Dsqr, gs, u_for_nl, C[f"{ec}:chi2"], C[f"{ec}:chi3"])

    if spec.has_nr:
        # neighbor-averaged partner (D-P) values at ec sites
        # (step_generic.cpp:740-743)
        g_1 = _avg4(plan, dmp[spec.dc1], spec.ax_own, spec.ax_1, sgn) \
            if spec.dc1 is not None else jnp.zeros_like(gs)
        g_2 = _avg4(plan, dmp[spec.dc2], spec.ax_own, spec.ax_2, sgn) \
            if spec.dc2 is not None else jnp.zeros_like(gs)
        eps = C[f"{ec}:nreps"]
        chi2 = C[f"{ec}:nrchi2"]
        u_lin = us if us is not None else 1.0
        seed_own = state["f"][ec]
        own, _, _ = _nr_solve(gs, g_1, g_2, eps, chi2,
                              seed_own, g_1 * u_lin, g_2 * u_lin)
        lin = jnp.where(chi2 != 0, own, lin)

    new_state = state
    ft_key = "e" if ec[0] == "e" else "h"
    has_pols = bool(plan.pol_specs_e if ft_key == "e" else plan.pol_specs_h)
    slab_ok = (plan.slab_opt and spec.dsigw_axis is not None
               and spec.dsigw_slabs is not None and not has_pols
               and not _is_pair(plan))
    if slab_ok:
        # outside the sigma_w slab E == u*D inductively (kappa_w=1,
        # sigma_w=0 makes the W chain copy lin); only the slabs need the
        # chain and the fw storage
        fw = state["f_w"][ec]
        f_old = state["f"][ec]
        f_new = lin
        new_fw = fw
        n_sites = plan.gv.num[spec.dsigw_axis] + 1
        for sl in _slab_slices(spec.dsigw_slabs, spec.dsigw_axis, n_sites,
                               lin.ndim):
            kwsl = tuple(s if C[f"{ec}:kapw"].shape[i] > 1 else slice(None)
                         for i, s in enumerate(sl))
            fw_sl = lin[sl]
            f_new = f_new.at[sl].set(
                f_old[sl] + (C[f"{ec}:kapw"][kwsl] + C[f"{ec}:sigw"][kwsl])
                * fw_sl
                - (C[f"{ec}:kapw"][kwsl] - C[f"{ec}:sigw"][kwsl]) * fw[sl])
            new_fw = new_fw.at[sl].set(fw_sl)
        new_state = {**new_state, "f_w": {**state["f_w"], ec: new_fw}}
    elif spec.dsigw_axis is not None:
        fw = state["f_w"][ec]
        fw_new = lin
        kapw, sigw = C[f"{ec}:kapw"], C[f"{ec}:sigw"]
        f_new = state["f"][ec] + (kapw + sigw) * fw_new - (kapw - sigw) * fw
        new_state = {**new_state, "f_w": {**state["f_w"], ec: fw_new}}
    else:
        f_new = lin

    f_new = _apply_mask(plan, C, ec, f_new)
    new_state = {**new_state, "f": {**new_state["f"], ec: f_new}}
    return new_state


def _pol_update(plan: Plan, C: Dict[str, Any], pi: int, p: PolSpec,
                state: Dict[str, Any]) -> Dict[str, Any]:
    """Susceptibility ADE dispatch: lorentzian/drude leapfrog
    (susceptibility.cpp:188-260), noisy variant (:317), gyrotropic
    precession (:445)."""
    if p.kind == "gyrotropic":
        return _pol_update_gyro(plan, C, pi, p, state)
    if p.kind == "multilevel":
        return _pol_update_multilevel(plan, C, pi, p, state)
    state = _pol_update_lorentzian(plan, C, pi, p, state)
    if p.kind == "noisy" and p.noise_amp != 0.0:
        state = _pol_add_noise(plan, C, pi, p, state)
    return state


def _pol_add_noise(plan: Plan, C, pi: int, p: PolSpec, state):
    """White-noise polarization driving (noisy_lorentzian_susceptibility,
    susceptibility.cpp:317-339): P += N(0, amp*sqrt(sigma))."""
    dt = plan.dt
    g2pi = 2 * math.pi * p.gamma
    w2pi = 2 * math.pi * p.omega0
    amp = w2pi * p.noise_amp * math.sqrt(g2pi) * dt * dt / (1 + g2pi * dt / 2)
    key = state["rng"]
    pol_st = state["pol"][pi]
    new_p = dict(pol_st["p"])
    for c in list(new_p):
        if "#" in c:
            continue
        d = G.component_direction(c)
        sig = C[f"pol{pi}:{c}:{d}"]
        key, sub = jax.random.split(key)
        noise = jax.random.normal(sub, new_p[c].shape,
                                  dtype=jnp.float32)
        if jnp.iscomplexobj(new_p[c]):
            key, sub2 = jax.random.split(key)
            noise = noise + 1j * jax.random.normal(sub2, new_p[c].shape,
                                                   dtype=jnp.float32)
        new_p[c] = new_p[c] + amp * jnp.sqrt(jnp.abs(sig)) * noise
    pols = list(state["pol"])
    pols[pi] = {**pol_st, "p": new_p}
    return {**state, "pol": pols, "rng": key}


def _yee_to_cent(plan, c, arr):
    """4-point average from component c's Yee sites to centered sites
    (yee2cent_offsets)."""
    gv = plan.gv
    ys = G.yee_shift(c, gv.dim)
    out = arr
    for ax, d in enumerate(gv.axes):
        if ys[d] == 0:
            out = 0.5 * (out + _sh(plan, out, ax, +1))
    return out


def _cent_to_yee(plan, c, arr):
    """Average from centered sites back to component c's Yee sites
    (cent2yee_offsets)."""
    gv = plan.gv
    ys = G.yee_shift(c, gv.dim)
    out = arr
    for ax, d in enumerate(gv.axes):
        if ys[d] == 0:
            out = 0.5 * (out + _sh(plan, out, ax, -1))
    return out


def _pol_update_multilevel(plan: Plan, C, pi: int, p: PolSpec, state):
    """Multilevel-atom update (multilevel_susceptibility::update_P,
    multilevel-atom.cpp:240-384): implicit population relaxation
    N' = GammaInv [(I - Gamma dt/2) N + alpha (E.dP + g_perp dt E.P_avg)],
    then per-transition damped oscillators driven by sigma_t W dN."""
    dt = plan.dt
    dt2 = 0.5 * dt
    L = len(p.ml_N0)
    T = len(p.ml_omega)
    Gamma = np.asarray(p.ml_Gamma, np.float64).reshape(L, L)
    alpha = np.asarray(p.ml_alpha, np.float64).reshape(L, T)
    GammaInv = np.linalg.inv(np.eye(L) + Gamma * dt2)
    IG = np.eye(L) - Gamma * dt2
    pol_st = state["pol"][pi]
    comps = sorted(pol_st["p"].keys())
    gv = plan.gv

    def W(c):
        return state["f_w"].get(c, state["f"].get(c))

    def W_prev(c):
        return state.get("f_w_prev", {}).get(c, W(c))

    # --- population update on the centered lattice -----------------------
    # (L x L) matrices applied as SCALAR-weighted sums, not einsums with
    # array operands: L is tiny (2-4 levels), so float scalars fold into
    # the elementwise ops
    N = state["pol"][pi]["N"]                      # (L,) + shape
    Ntmp = [sum(float(IG[l, m]) * N[m] for m in range(L) if IG[l, m])
            for l in range(L)]
    # E (current+previous) averaged to centered sites: "E8"/8
    Ec = {c: _yee_to_cent(plan, c, W(c)) + _yee_to_cent(plan, c, W_prev(c))
          for c in comps}                          # 2*E_avg
    for t in range(T):
        gperpdt = float(p.ml_gamma[t]) * math.pi * dt
        EdP = 0.0
        EPave = 0.0
        for c in comps:
            pc = pol_st["p"][c][t]
            ppc = pol_st["pp"][c][t]
            dP = _yee_to_cent(plan, c, pc - ppc)
            Pave = _yee_to_cent(plan, c, pc + ppc)
            EdP = EdP + dP * Ec[c] * 0.5           # (2E)(dP)/ (2*2)... see below
            EPave = EPave + Pave * Ec[c] * 0.25
        # reference: EdP32/32 with 8E * 4dP -> (2E*dP)*... our Ec=2E_avg,
        # dP=dP_avg: EdP_ref = (2E)(dP)/4 matches 0.5 factor above /2:
        EdP = EdP * 0.5
        EPave = EPave * 0.5
        drive_t = EdP + gperpdt * EPave
        Ntmp = [Ntmp[l] + float(alpha[l, t]) * drive_t for l in range(L)]
    N_new = jnp.stack([sum(float(GammaInv[l, m]) * Ntmp[m]
                           for m in range(L) if GammaInv[l, m])
                       for l in range(L)])

    # --- per-transition polarization oscillators --------------------------
    new_p = {c: pol_st["p"][c] for c in comps}
    new_pp = {c: pol_st["pp"][c] for c in comps}
    dind = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}
    for t in range(T):
        w2pi = 2 * math.pi * float(p.ml_omega[t])
        g2pi = 2 * math.pi * float(p.ml_gamma[t])
        gperp = math.pi * float(p.ml_gamma[t])
        om_corr = w2pi * w2pi * dt * dt + gperp * gperp * dt * dt
        gamma1inv = 1.0 / (1 + g2pi * dt2)
        gamma1 = 1 - g2pi * dt2
        lp = int(np.argmax(alpha[:, t] > 0))
        lm = int(np.argmax(alpha[:, t] < 0))
        dN_cent = N_new[lp] - N_new[lm]
        for c in comps:
            d0 = G.component_direction(c)
            st_val = float(np.asarray(p.ml_sigmat).reshape(T, -1)[t][
                dind[d0]])
            if st_val == 0.0:
                continue
            sig = C[f"pol{pi}:{c}:{d0}"]
            dNi = _cent_to_yee(plan, c, dN_cent)
            pc = pol_st["p"][c][t]
            ppc = pol_st["pp"][c][t]
            pn = gamma1inv * (pc * (2 - om_corr) - gamma1 * ppc
                              - dt * dt * (st_val * sig * W(c)) * dNi)
            new_p[c] = new_p[c].at[t].set(pn)
            new_pp[c] = new_pp[c].at[t].set(pc)
    pols = list(state["pol"])
    pols[pi] = {"p": new_p, "pp": new_pp, "N": N_new}
    return {**state, "pol": pols}


def _pol_update_gyro(plan: Plan, C, pi: int, p: PolSpec, state):
    """Gyrotropic precession: Lorentzian/Drude
    (gyrotropic_susceptibility::update_P, susceptibility.cpp:445-517) or
    saturated linearized Landau-Lifshitz-Gilbert (susceptibility.cpp:519
    GYROTROPIC_SATURATED): per-site 3x3 skew-symmetric solve with bias
    vector b (unit axis in the saturated model)."""
    dt = plan.dt
    w2pidt = 2 * math.pi * p.omega0 * dt
    g2pidt = 2 * math.pi * p.gamma * dt
    omega0dtsqr = w2pidt * w2pidt
    gamma1 = 1 - g2pidt / 2
    diag = 2 - (0.0 if p.drude else omega0dtsqr)
    pt = math.pi * dt
    dt2pi = 2 * math.pi * dt
    alpha = p.gyro_alpha
    bx, by, bz = p.bias
    # gyro tensor g[i][j] = eps_ijk b_k (skew)
    gmat = np.array([[0.0, bz, -by], [-bz, 0.0, bx], [by, -bx, 0.0]])
    if p.saturated:
        # LLG: (1/2)(P+ - P-) = -g2pidt P + g.(alpha/2 (P- + P+)
        #       - w2pidt P + dt2pi s W); the alpha P+ term rides the
        #       skew inverse below
        gd, gx, gy, gz = 0.5, -0.5 * alpha * bx, -0.5 * alpha * by, \
            -0.5 * alpha * bz
    else:
        gd, gx, gy, gz = 1 + g2pidt / 2, pt * bx, pt * by, pt * bz
    invdet = 1.0 / gd / (gd * gd + gx * gx + gy * gy + gz * gz)
    inv = np.array([
        [invdet * (gd * gd + gx * gx), invdet * (gx * gy + gd * gz),
         invdet * (gx * gz - gd * gy)],
        [invdet * (gy * gx - gd * gz), invdet * (gd * gd + gy * gy),
         invdet * (gy * gz + gd * gx)],
        [invdet * (gz * gx + gd * gy), invdet * (gz * gy - gd * gx),
         invdet * (gd * gd + gz * gz)]])
    gv = plan.gv
    pol_st = state["pol"][pi]
    new_p = dict(pol_st["p"])
    new_pp = dict(pol_st["pp"])

    def W(c):
        return state["f_w"].get(c, state["f"].get(c))

    for c in [k for k in pol_st["p"] if "#" not in k]:
        d0 = G.component_direction(c)
        sgn = 1 if c[0] == "e" else -1
        s_arr = C[f"pol{pi}:{c}:{d0}"]
        d1 = G.cycle_direction(gv.dim, d0, 1)
        d2 = G.cycle_direction(gv.dim, d0, 2)
        i0 = "xyz".index(d0)
        i1 = "xyz".index(d1)
        i2 = "xyz".index(d2)
        # own-axis stagger may be absent on reduced grids (1d: ex/ey
        # share the z lattice, so the gs_2 average degrades gracefully
        # to 2-point / identity; step_generic.cpp's LOOP handles this
        # via the collapsed stride)
        ax_own = gv.axis_of(d0) if gv.has_direction(d0) else None
        w0 = W(c)
        c1 = c[0] + d1
        c2 = c[0] + d2
        w1 = W(c1)
        w2 = W(c2)

        def _avg(w, d_other):
            ax_off = gv.axis_of(d_other) if gv.has_direction(d_other) \
                else None
            if ax_own is not None and ax_off is not None:
                return _avg4(plan, w, ax_own, ax_off, sgn)
            if ax_own is not None:
                return 0.5 * (w + _sh(plan, w, ax_own, sgn))
            if ax_off is not None:
                return 0.5 * (w + _sh(plan, w, ax_off, -sgn))
            return w
        avg1 = _avg(w1, d1) if w1 is not None else 0.0
        avg2 = _avg(w2, d2) if w2 is not None else 0.0
        p0, p1v, p2v = (pol_st["p"][c], pol_st["p"][f"{c}#1"],
                        pol_st["p"][f"{c}#2"])
        pp0, pp1, pp2 = (pol_st["pp"][c], pol_st["pp"][f"{c}#1"],
                         pol_st["pp"][f"{c}#2"])
        if p.saturated:
            q0 = -w2pidt * p0 + 0.5 * alpha * pp0 + dt2pi * s_arr * w0
            q1 = -w2pidt * p1v + 0.5 * alpha * pp1 + dt2pi * s_arr * avg1
            q2 = -w2pidt * p2v + 0.5 * alpha * pp2 + dt2pi * s_arr * avg2
            r0 = 0.5 * pp0 - g2pidt * p0 \
                + gmat[i0][i1] * q1 + gmat[i0][i2] * q2
            r1 = 0.5 * pp1 - g2pidt * p1v \
                + gmat[i1][i2] * q2 + gmat[i1][i0] * q0
            r2 = 0.5 * pp2 - g2pidt * p2v \
                + gmat[i2][i0] * q0 + gmat[i2][i1] * q1
        else:
            r0 = diag * p0 - gamma1 * pp0 + omega0dtsqr * s_arr * w0 \
                - pt * gmat[i0][i1] * pp1 - pt * gmat[i0][i2] * pp2
            r1 = diag * p1v - gamma1 * pp1 + omega0dtsqr * s_arr * avg1 \
                - pt * gmat[i1][i0] * pp0 - pt * gmat[i1][i2] * pp2
            r2 = diag * p2v - gamma1 * pp2 + omega0dtsqr * s_arr * avg2 \
                - pt * gmat[i2][i1] * pp1 - pt * gmat[i2][i0] * pp0
        new_pp[c], new_pp[f"{c}#1"], new_pp[f"{c}#2"] = p0, p1v, p2v
        new_p[c] = inv[i0][i0] * r0 + inv[i0][i1] * r1 + inv[i0][i2] * r2
        new_p[f"{c}#1"] = inv[i1][i0] * r0 + inv[i1][i1] * r1 + inv[i1][i2] * r2
        new_p[f"{c}#2"] = inv[i2][i0] * r0 + inv[i2][i1] * r1 + inv[i2][i2] * r2
    pols = list(state["pol"])
    pols[pi] = {"p": new_p, "pp": new_pp}
    return {**state, "pol": pols}


def _pol_update_lorentzian(plan: Plan, C: Dict[str, Any], pi: int, p: PolSpec,
                state: Dict[str, Any]) -> Dict[str, Any]:
    """Lorentzian/Drude ADE leapfrog (susceptibility.cpp:188-260)."""
    dt = plan.dt
    w2pi = 2 * math.pi * p.omega0
    g2pi = 2 * math.pi * p.gamma
    omega0dtsqr = (w2pi * dt) ** 2
    gamma1inv = 1.0 / (1 + 0.5 * g2pi * dt)
    gamma1 = 1 - 0.5 * g2pi * dt
    denom = 0.0 if p.drude else omega0dtsqr

    pol_st = state["pol"][pi]
    new_p = dict(pol_st["p"])
    new_pp = dict(pol_st["pp"])
    gv = plan.gv

    def W(c):
        return state["f_w"].get(c, state["f"].get(c))

    for c in pol_st["p"]:
        d = G.component_direction(c)
        sgn = 1 if c[0] == "e" else -1
        s = C[f"pol{pi}:{c}:{d}"]
        drive = s * W(c)
        ax_own = gv.axis_of(d) if gv.has_direction(d) else None
        d1 = G.cycle_direction(gv.dim, d, 1)
        d2 = G.cycle_direction(gv.dim, d, 2)
        aniso = False
        for doff in (d1, d2):
            key = f"pol{pi}:{c}:{doff}"
            c_off = c[0] + doff
            if key in C and W(c_off) is not None and gv.has_direction(doff) \
                    and ax_own is not None:
                aniso = True
                drive = drive + _offdiag(plan, C[key], W(c_off),
                                         gv.axis_of(doff), ax_own, sgn)
        pcur = pol_st["p"][c]
        pprev = pol_st["pp"][c]
        pnew = gamma1inv * (pcur * (2 - denom) - gamma1 * pprev
                            + omega0dtsqr * drive)
        if aniso:
            # s==0 guard against material-boundary instabilities (PR #666,
            # susceptibility.cpp:231)
            pnew = jnp.where(s != 0, pnew, pcur)
        new_p[c] = pnew
        new_pp[c] = pcur

    pols = list(state["pol"])
    pols[pi] = {"p": new_p, "pp": new_pp}
    return {**state, "pol": pols}


def _compute_fmp(plan: Plan, C: Dict[str, Any], ft: str,
                 state: Dict[str, Any], xs: Dict[str, Any]) -> Dict[str, Any]:
    """f_minus_p = D - sum P - integrated source dipoles
    (update_eh.cpp:119-146)."""
    ft2 = "d" if ft == "e" else "b"
    specs = plan.eh_specs_e if ft == "e" else plan.eh_specs_h
    pol_specs = plan.pol_specs_e if ft == "e" else plan.pol_specs_h
    pol_off = 0 if ft == "e" else len(plan.pol_specs_e)
    fmp = {}
    for spec in specs:
        fmp[spec.dc] = state["f"][spec.dc]
    for k, p in enumerate(pol_specs):
        pi = pol_off + k
        for c, parr in state["pol"][pi]["p"].items():
            if "#" in c:
                continue  # gyrotropic off-axis P entries are internal
            dc = ft2 + c[1]
            if dc in fmp:
                if parr.ndim == fmp[dc].ndim + 1:
                    # multilevel: sum the per-transition stack
                    fmp[dc] = fmp[dc] - parr.sum(axis=0)
                else:
                    fmp[dc] = fmp[dc] - parr
    # integrated sources (polarization-like)
    for si, s in enumerate(plan.sources):
        if s.is_integrated and s.component[0] == ft:
            dc = ft2 + s.component[1]
            if dc not in fmp:
                continue
            key = f"src{si}:dip_re"
            if key not in xs:
                continue
            w_re, w_im = xs[key], xs[f"src{si}:dip_im"]
            a_re, a_im = C[f"src{si}:amp_re"], C[f"src{si}:amp_im"]
            idx = C[f"src{si}:idx"]
            if _is_pair(plan):
                fmp[dc] = fmp[dc].at[(0,) + tuple(idx.T)].add(
                    -(w_re * a_re - w_im * a_im)) \
                    .at[(1,) + tuple(idx.T)].add(
                    -(w_re * a_im + w_im * a_re))
                continue
            if plan.complex_fields:
                contrib = (w_re + 1j * w_im) * (a_re + 1j * a_im)
            else:
                contrib = w_re * a_re - w_im * a_im
            fmp[dc] = fmp[dc].at[tuple(idx.T)].add(-contrib)
    return fmp


def _apply_sources(plan: Plan, C: Dict[str, Any], ft2: str,
                   state: Dict[str, Any], xs: Dict[str, Any]) -> Dict[str, Any]:
    """Current sources into D/B: f -= current * dt [* cndinv]
    (step.cpp:296-319).

    When the component ALSO carries increment-coupled PML auxiliaries —
    fcnd (step_generic.cpp:58-62) and/or the f_u sigu chain — the same
    increment must go into them: unlike the reference, whose interior
    chunks have no PML direction and update f directly, this stepper's
    monolithic arrays run the aux chains everywhere whenever PML exists,
    and f only receives the innermost aux's *increments*.  A source
    added to f alone is then a charge the inner chain (and so the
    conductivity) never sees — a static ghost dipole that corrupts every
    conductive response; the Casimir sigma>0 bias came from exactly
    this."""
    f = dict(state["f"])
    f_cond = dict(state.get("f_cond", {}))
    # f_u mirroring only matters (and only changes anything) where the
    # inner chain is value-dependent in the interior, i.e. conductivity
    cond_c = {s.c for s in plan.curl_specs_d + plan.curl_specs_b
              if s.has_cond}
    f_u = {k: v for k, v in state.get("f_u", {}).items() if k in cond_c}
    dt = plan.dt
    for si, s in enumerate(plan.sources):
        ftc = "d" if s.component[0] == "e" else "b"
        if ftc != ft2 or s.is_integrated:
            continue
        key = f"src{si}:cur_re"
        if key not in xs:
            continue
        dc = ft2 + s.component[1]
        if dc not in f:
            continue
        w_re, w_im = xs[key], xs[f"src{si}:cur_im"]
        a_re, a_im = C[f"src{si}:amp_re"], C[f"src{si}:amp_im"]
        idx = C[f"src{si}:idx"]
        if _is_pair(plan):
            A_re = (w_re * a_re - w_im * a_im) * dt
            A_im = (w_re * a_im + w_im * a_re) * dt
            if f"src{si}:cndinv" in C:
                cnd = C[f"src{si}:cndinv"]
                A_re, A_im = A_re * cnd, A_im * cnd
            for aux in (f_cond, f_u):
                if dc in aux:
                    aux[dc] = aux[dc].at[(0,) + tuple(idx.T)].add(-A_re) \
                                     .at[(1,) + tuple(idx.T)].add(-A_im)
            f[dc] = f[dc].at[(0,) + tuple(idx.T)].add(-A_re) \
                         .at[(1,) + tuple(idx.T)].add(-A_im)
            continue
        if plan.complex_fields:
            A = (w_re + 1j * w_im) * (a_re + 1j * a_im) * dt
        else:
            A = (w_re * a_re - w_im * a_im) * dt
        if f"src{si}:cndinv" in C:
            A = A * C[f"src{si}:cndinv"]
        contrib = A
        f[dc] = f[dc].at[tuple(idx.T)].add(-contrib)
        for aux in (f_cond, f_u):
            if dc in aux:
                aux[dc] = aux[dc].at[tuple(idx.T)].add(-contrib)
    out = {**state, "f": f}
    if f_cond:
        out["f_cond"] = f_cond
    if f_u:
        out["f_u"] = {**state["f_u"], **f_u}
    return out


def _centered_avg(plan: Plan, c: str, arr: jnp.ndarray) -> jnp.ndarray:
    """Average a component to the centered grid (dft.cpp:277 avg1/avg2)."""
    gv = plan.gv
    ys = G.yee_shift(c, gv.dim)
    out = arr
    for ax, d in enumerate(gv.axes):
        if ys[d] == 0:
            out = 0.5 * (out + _sh(plan, out, ax, +1))
    return out


def dft_view(arr):
    """Complex view of a real-pair DFT accumulator (..., nfreq, 2); a
    complex array passes through unchanged (host-side convenience)."""
    import numpy as _np
    if _np.iscomplexobj(arr):
        return arr
    return arr[..., 0] + 1j * arr[..., 1]


def dft_store(c, dtype=None):
    """Inverse of dft_view: complex -> real-pair (..., nfreq, 2)."""
    out = jnp.stack([jnp.real(c), jnp.imag(c)], axis=-1)
    return out.astype(dtype) if dtype is not None else out


def _dft_update(plan: Plan, C: Dict[str, Any], state: Dict[str, Any],
                xs: Dict[str, Any]) -> Dict[str, Any]:
    """DTFT accumulator update (dft.cpp:265 in-step sampling)."""
    dft = dict(state["dft"])
    for mi, m in enumerate(plan.dfts):
        key = f"dft{mi}:ph_re"
        if key not in xs:
            continue
        if m.centered:
            favg = _centered_avg(plan, m.component,
                                 state["f"][m.component])
        else:
            favg = state["f"][m.component]
        sl = tuple(slice(a, b) for a, b in m.region)
        if favg.ndim > plan.gv.ndim:      # real-pair channel axis
            fv = favg[(slice(None),) + sl]
        else:
            fv = favg[sl]
        # fully-REAL accumulation into the (re, im) pair accumulator:
        # c = w*fv expanded into (cr, ci) real parts, then
        # acc_re += cr ph_re - ci ph_im, acc_im += cr ph_im + ci ph_re
        phr = xs[key]
        phi = xs[f"dft{mi}:ph_im"]
        wi = None
        if f"dft{mi}:w" in C:
            wr = C[f"dft{mi}:w"]
        else:
            wr = C[f"dft{mi}:wre"]
            wi = C[f"dft{mi}:wim"]
        if fv.ndim > len(m.region):           # real-pair (2, ...) slice
            fr, fi = fv[0], fv[1]
        elif jnp.iscomplexobj(fv):
            fr, fi = jnp.real(fv), jnp.imag(fv)
        else:
            fr, fi = fv, None
        cr = wr * fr
        ci = wr * fi if fi is not None else None
        if wi is not None:
            if fi is not None:
                cr = cr - wi * fi
            ci = (ci + wi * fr) if ci is not None else wi * fr
        dre = cr[..., None] * phr
        dim = cr[..., None] * phi
        if ci is not None:
            dre = dre - ci[..., None] * phi
            dim = dim + ci[..., None] * phr
        dft[m.name] = dft[m.name] + jnp.stack([dre, dim], axis=-1)
    return {**state, "dft": dft}


def _axis_specials(plan: Plan, C, ft2: str, state):
    """Cylindrical r=0 updates that replace the singular curl terms
    (step_db.cpp:296-457).

    m=0:  d(Dz)/dt|_{r=0} = (4/dr) Hp(dr/2)  (the limit of (1/r)d(rHp)/dr)
    |m|=1: d(Dp)/dt|_{r=0} = dHr/dz - 2 Hz(dr/2)/dr
           d(Br)/dt|_{r=0} = dEp/dz - i m Ez(ring1)/dr
    (other components at the axis are masked to zero by the plan)."""
    gv = plan.gv
    if gv.dim != "cyl" or abs(gv.origin[gv.axis_of("r")]) > 1e-12:
        return state
    rax = gv.axis_of("r")
    zax = 1 - rax
    Cc = plan.courant
    f = dict(state["f"])

    def ring(arr, i=0):
        off = arr.ndim - gv.ndim
        idx = [slice(None)] * arr.ndim
        idx[rax + off] = i
        return arr[tuple(idx)]

    def set_ring(arr, val, i=0):
        off = arr.ndim - gv.ndim
        idx = [slice(None)] * arr.ndim
        idx[rax + off] = i
        return arr.at[tuple(idx)].set(val)

    # NOTE: the regular curl update already ran on ring 0 (with the radial
    # terms masked to zero or half-counted); these are the CORRECTIONS that
    # complete it.  PML chains are bypassed on the axis ring (sigma_r = 0 on
    # the axis; only the z-PML corner sees a slight mismatch).
    if plan.m == 0 and ft2 == "d" and "dz" in f and "hp" in f:
        # (1/r) d(r Hp)/dr -> (4/dr) Hp(dr/2); the masked rfinv gave 0
        new0 = ring(f["dz"]) + 4 * Cc * ring(f["hp"])
        f["dz"] = set_ring(f["dz"], new0)
    elif abs(plan.m) == 1:
        if ft2 == "d" and "dp" in f and "hz" in f:
            # -dHz/dr at r=0: the zero-filled diff gave -Hz(dr/2)/dr; the
            # correct antisymmetric limit is -2 Hz(dr/2)/dr: add the half
            new0 = ring(f["dp"]) - Cc * ring(f["hz"])
            f["dp"] = set_ring(f["dp"], new0)
        if ft2 == "b" and "br" in f and "ez" in f:
            # -i m Ez/r at r=0 evaluated one ring in (step_db.cpp:356)
            ez1 = ring(f["ez"], 1)
            if _is_pair(plan):
                new0 = ring(f["br"]) + _pair_cmul(ez1, 0.0, -plan.m * Cc)
            else:
                new0 = ring(f["br"]) - 1j * plan.m * Cc * ez1
            f["br"] = set_ring(f["br"], new0)
    else:
        return state
    # re-apply the masks on the touched rings
    for c in list(f):
        if f[c] is not state["f"][c]:
            f[c] = _apply_mask(plan, C, c, f[c])
    return {**state, "f": f}


# ---------------------------------------------------------------------------
# The full step + scan driver
# ---------------------------------------------------------------------------


def make_step(plan: Plan):
    """Returns step(state, xs_t, coefs=None) -> state implementing
    fields::step (step.cpp:35-140) for one timestep.

    Coefficients are threaded as an argument (not closure constants) so that
    jit receives them as device buffers rather than embedding multi-MB
    constants into the HLO."""

    if getattr(plan, "slab_store", False):
        from .slabstep import slab_supported, make_step_slab
        if slab_supported(plan):
            return make_step_slab(plan)

    def step(state: Dict[str, Any], xs: Dict[str, Any],
             C: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if C is None:
            C = plan.coefs
        # --- B half ---------------------------------------------------------
        for spec in plan.curl_specs_b:
            state = _curl_update(plan, C, spec, state)
            state = _bfast_update(plan, C, spec, state)
        state = _axis_specials(plan, C, "b", state)
        state = _apply_sources(plan, C, "b", state, xs)
        if "f_w_prev" in state:
            fwp = dict(state["f_w_prev"])
            for c in fwp:
                if c[0] == "h":
                    fwp[c] = state["f_w"].get(c, state["f"].get(c))
            state = {**state, "f_w_prev": fwp}
        dmp_h = _compute_fmp(plan, C, "h", state, xs) if plan.have_fmp_h else \
            {s.dc: state["f"][s.dc] for s in plan.eh_specs_h}
        for spec in plan.eh_specs_h:
            state = _eh_update(plan, C, spec, state, dmp_h)
        for k in range(len(plan.pol_specs_h)):
            state = _pol_update(plan, C, len(plan.pol_specs_e) + k,
                                plan.pol_specs_h[k], state)
        # --- D half ---------------------------------------------------------
        for spec in plan.curl_specs_d:
            state = _curl_update(plan, C, spec, state)
            state = _bfast_update(plan, C, spec, state)
        state = _axis_specials(plan, C, "d", state)
        state = _apply_sources(plan, C, "d", state, xs)
        if "f_w_prev" in state:
            fwp = dict(state["f_w_prev"])
            for c in fwp:
                if c[0] == "e":
                    fwp[c] = state["f_w"].get(c, state["f"].get(c))
            state = {**state, "f_w_prev": fwp}
        dmp_e = _compute_fmp(plan, C, "e", state, xs) if plan.have_fmp_e else \
            {s.dc: state["f"][s.dc] for s in plan.eh_specs_e}
        for spec in plan.eh_specs_e:
            state = _eh_update(plan, C, spec, state, dmp_e)
        for k in range(len(plan.pol_specs_e)):
            state = _pol_update(plan, C, k, plan.pol_specs_e[k], state)
        # --- monitors ---------------------------------------------------------
        state = {**state, "t": state["t"] + 1}
        state = _dft_update(plan, C, state, xs)
        return state

    return step


def build_xs(plan: Plan, nsteps: int, t0: int = 0) -> Dict[str, Any]:
    """Per-step host-precomputed tables: source waveforms and DTFT phases.

    Source sampling times follow step.cpp:64-106: B currents at t*dt, D
    currents at (t+0.5)*dt, integrated H dipoles at (t+0.5)*dt, integrated E
    dipoles at (t+1)*dt.  DTFT phases use the *post-increment* step counter
    (dft.cpp:252-257): E components at (t+1)*dt, H at (t+0.5)*dt.
    """
    dt = plan.dt
    steps = np.arange(t0, t0 + nsteps)
    xs: Dict[str, Any] = {}
    # every table is split into re/im float arrays and recombined inside
    # the step
    rdtype = np.float32 if plan.dtype != np.float64 else np.float64
    for si, s in enumerate(plan.sources):
        st = s.src_time
        is_h_family = s.component[0] == "h"
        if s.is_integrated:
            tt = (steps + (0.5 if is_h_family else 1.0)) * dt
            w = np.asarray([st.dipole(t) for t in tt], np.complex128)
            xs[f"src{si}:dip_re"] = w.real.astype(rdtype)
            xs[f"src{si}:dip_im"] = w.imag.astype(rdtype)
        else:
            tt = (steps + (0.0 if is_h_family else 0.5)) * dt
            w = np.asarray([st.current(t, dt) for t in tt], np.complex128)
            xs[f"src{si}:cur_re"] = w.real.astype(rdtype)
            xs[f"src{si}:cur_im"] = w.imag.astype(rdtype)
    for mi, m in enumerate(plan.dfts):
        is_h = m.component[0] in ("h", "b")
        tE = (steps + 1) * dt
        tt = tE - 0.5 * dt if is_h else tE
        omegas = 2 * np.pi * np.asarray(m.freqs)
        ph = np.exp(1j * omegas[None, :] * tt[:, None]) \
            * (m.scale * dt / math.sqrt(2 * math.pi) * m.decimation)
        live = ((steps + 1) % m.decimation) == 0
        ph = ph * live[:, None]
        xs[f"dft{mi}:ph_re"] = ph.real.astype(rdtype)
        xs[f"dft{mi}:ph_im"] = ph.imag.astype(rdtype)
    # host (numpy) arrays: callers pass these into jit, which uploads
    # them once at dispatch (jnp arrays here would cost a device round
    # trip per table for every caller that reshapes with np.asarray)
    return xs


def run(plan: Plan, state: Dict[str, Any], nsteps: int,
        jit: bool = True, t0: Optional[int] = None,
        probes: Sequence["ProbeSpec"] = ()):
    """Scan the step over nsteps (the inner loop of Simulation.run,
    simulation.py:2795).

    Pass `t0` to skip the device-to-host read of state['t'].

    `probes` are point samplers emitted as per-step scan outputs (the analog
    of get_field time series feeding Harminv, bands.cpp/monitor.cpp); when
    given, returns (state, {name: (nsteps,) series}).
    """
    if t0 is None:
        t0 = int(state["t"])
    xs = build_xs(plan, nsteps, t0)

    # cache the jitted runner per (nsteps, probes) on the plan: repeated
    # block runs (at_every, stop-condition polling) reuse one executable
    # instead of retracing a fresh closure
    cache = getattr(plan, "_run_cache", None)
    if cache is None:
        cache = plan._run_cache = {}
    # probe identity (component + index/weight content) must be part of the
    # key: names are auto-generated ('hm{i}') so two different collectors on
    # the same Simulation would otherwise collide on a cached closure
    key = (nsteps, jit, tuple(
        (p.name, p.component,
         hashlib.sha1(np.ascontiguousarray(p.indices).tobytes()
                      + np.ascontiguousarray(p.weights).tobytes()).hexdigest())
        for p in probes))
    runner = cache.get(key)
    if runner is None:
        step = make_step(plan)
        pidx = {p.name: jnp.asarray(p.indices, jnp.int32) for p in probes}
        pair_mode = _is_pair(plan) and plan.complex_fields
        if pair_mode:
            pwr = {p.name: jnp.asarray(np.real(p.weights), plan.dtype)
                   for p in probes}
            pwi = {p.name: jnp.asarray(np.imag(p.weights), plan.dtype)
                   for p in probes}
        else:
            pw = {p.name: jnp.asarray(p.weights) for p in probes}

        def probe_val(ns, p):
            if pair_mode:
                vals = ns["f"][p.component][
                    (slice(None),) + tuple(pidx[p.name].T)]
                fr, fi = vals[0], vals[1]
                wr, wi = pwr[p.name], pwi[p.name]
                return jnp.stack([jnp.sum(fr * wr - fi * wi),
                                  jnp.sum(fr * wi + fi * wr)])
            return jnp.sum(ns["f"][p.component][tuple(pidx[p.name].T)]
                           * pw[p.name])

        def runner(state, xs, C):
            def body(carry, x):
                ns = step(carry, x, C)
                out = {p.name: probe_val(ns, p) for p in probes}
                return ns, out
            # unroll=4 beats unroll=1 on an H100 at 384^3 (vacuum-uPML
            # 5.04 vs 6.52 ms/step, flagship 17.58 vs 22.00; NVIDIA H100
            # 80GB HBM3 at a 400 W power limit)
            state, ys = jax.lax.scan(body, state, xs, length=nsteps,
                                     unroll=4 if nsteps % 4 == 0 else 1)
            return state, ys

        if jit:
            runner = jax.jit(runner)
        cache[key] = runner
    state, ys = runner(state, xs, plan.coefs)
    if probes:
        return state, ys
    return state


@dataclasses.dataclass
class ProbeSpec:
    """Point (or weighted-stencil) field sampler emitted every step."""
    name: str
    component: str
    indices: Any        # (npts, ndim) int
    weights: Any        # (npts,)
