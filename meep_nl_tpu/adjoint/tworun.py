"""Two-run (physical) adjoint gradients through the production stepper.

The reference computes topology-optimization gradients with an explicit
forward-run / adjoint-run pair (python/adjoint/optimization_problem.py:159,
create_adjoint_sources utils.py:221) and a C++ pairing kernel
(material_grids_addgradient, meepgeom.cpp:2829).  `optimization.py` replaces
that with native jax.grad through the lax.scan time loop — exact, but it
pays sqrt-T rematerialization and holds the checkpointed states in device
memory.  This module restores the two-run structure: both runs are plain
forward `stepper.step.run` calls, so they cost what a forward run costs.

Pairing identity (calibrated EXACTLY against jax.grad ground truth over
f0/resolution/epsilon/monitor-weight sweeps, scripts/adjoint_pair_calib*.py;
relative residual < 1e-6 once both runs are decayed):

    dJ/du_c(x) = sum_f Re[ Z_c(f) * (Lam_c(x,f) / shat(f)) * Ehat_c(x,f) ]
                 / u_c(x)^2

where u_c = the inverse-epsilon plan row of E component c,
Ehat_c = forward-run DTFT of E_c over the design region,
Lam_c  = adjoint-run DTFT of E_c (adjoint sources below),
shat   = DTFT of the adjoint source pulse at the objective frequency,
    Z_e(f) = i sqrt(8 pi) wt(f),   wt = (2/dt) sin(w dt / 2),
and the 1/u^2 factor makes the pairing one between D-field DTFTs
(dJ/du(x) = sum_t lambda_E^t(x) D^t(x) with D = E/u, exactly).

Adjoint sources: for every monitor DftSpec m with objective cotangent
C(x,f) = dJ/d acc_re - i dJ/d acc_im at site x, inject a current of m's
component at m's sites with amplitude

    amp(x) = C(x,f) * w(x) * m.scale * (-1 if m.component is magnetic)

(w = the monitor's weight array; the -1 is the measured magnetic-current
pairing constant Z_h = -Z_e).  Centered monitors sample the 0.5/0.5
tangential average (dft.cpp:277), so their cotangent is spread back through
the transposed stencil onto the raw lattice.  Decimated monitors need no
special handling: build_xs scales live-step phases by the decimation factor,
which is exactly the transposed drive.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import grid as G
from ..stepper.plan import Plan, DftSpec, SrcVolSpec
from ..stepper import step as S
from ..models.source import GaussianSource

_SRC_DFT_KEY = re.compile(r"^(src|dft)\d+:")


def plan_with(plan: Plan, sources: Optional[Sequence] = None,
              dfts: Optional[Sequence] = None) -> Plan:
    """A plan variant sharing every material/PML coefficient row but with
    different sources and/or DFT monitors (the src*/dft* coef entries are
    rebuilt exactly as compile_plan does, plan.py:749-771)."""
    srcs = list(plan.sources) if sources is None else list(sources)
    dfts_ = list(plan.dfts) if dfts is None else list(dfts)
    coefs = {k: v for k, v in plan.coefs.items()
             if not _SRC_DFT_KEY.match(k)}
    for si, s in enumerate(srcs):
        coefs[f"src{si}:idx"] = np.asarray(s.indices, np.int32)
        amp = np.asarray(s.amps, np.complex128)
        coefs[f"src{si}:amp_re"] = amp.real.astype(plan.dtype)
        coefs[f"src{si}:amp_im"] = amp.imag.astype(plan.dtype)
        # conductive-site source rescaling (step.cpp:300-309) needs the
        # material's cond rows, which the compiled plan does not retain;
        # reuse an existing matching entry when the same source layout is
        # kept, otherwise require cond-free source sites
        old = f"src{si}:cndinv"
        if old in plan.coefs and sources is None:
            coefs[old] = plan.coefs[old]
    for mi, mspec in enumerate(dfts_):
        w = np.asarray(mspec.weights)
        if np.iscomplexobj(w):
            coefs[f"dft{mi}:wre"] = w.real.astype(plan.dtype)
            coefs[f"dft{mi}:wim"] = w.imag.astype(plan.dtype)
        else:
            coefs[f"dft{mi}:w"] = w.astype(plan.dtype)
    return dataclasses.replace(plan, sources=srcs, dfts=dfts_, coefs=coefs)


def _Z_e(freq: float, dt: float) -> complex:
    w = 2 * np.pi * freq
    wt = (2.0 / dt) * np.sin(w * dt / 2)
    return 1j * np.sqrt(8 * np.pi) * wt


def _src_spectrum(src_time, freq: float, nsteps: int, dt: float) -> complex:
    """DTFT of the adjoint pulse with the E-current sampling convention
    (build_xs, step.py:1328) — the convention the pairing constants were
    calibrated against."""
    ts = (np.arange(nsteps) + 0.5) * dt
    wfm = np.array([src_time.current(t, dt) for t in ts], np.complex128)
    return complex(np.sum(wfm * np.exp(1j * 2 * np.pi * freq * ts)) * dt)


def _spread_centered(plan: Plan, m: DftSpec, amp: np.ndarray,
                     keep_zeros: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Transpose of the monitor's sampling stencil: map a cotangent grid on
    the (possibly centered) monitor region to (indices, amps) on the raw
    component lattice.  Centered axes (integer Yee shift, dft.cpp:277
    avg1/avg2) spread 0.5/0.5 onto sites {x, x+1}."""
    gv = plan.gv
    lo = [a for a, b in m.region]
    A = np.asarray(amp, np.complex128)
    if m.centered:
        ys = G.yee_shift(m.component, gv.dim)
        for ax, d in enumerate(gv.axes):
            if ys[d] != 0:
                continue
            # favg[x] = (f[x] + f[x+1])/2  =>  drive[y] += 0.5 A[y-lo]
            # + 0.5 A[y-1-lo]; footprint grows by one on the high side
            shp = list(A.shape)
            shp[ax] += 1
            B = np.zeros(shp, np.complex128)
            sl_lo = tuple(slice(0, s) if a == ax else slice(None)
                          for a, s in enumerate(A.shape))
            sl_hi = tuple(slice(1, s + 1) if a == ax else slice(None)
                          for a, s in enumerate(A.shape))
            B[sl_lo] += 0.5 * A
            B[sl_hi] += 0.5 * A
            A = B
            if lo[ax] + A.shape[ax] > gv.shape[ax]:
                raise NotImplementedError(
                    "adjoint source for a centered monitor touching the "
                    "high grid edge (periodic wrap) is not supported")
    if keep_zeros:
        nz = np.nonzero(np.ones_like(A, dtype=bool))
    else:
        nz = np.nonzero(A)
    idx = np.stack([n + l for n, l in zip(nz, lo)], axis=1).astype(np.int32)
    return idx, A[nz]


def _monitor_coef_weights(plan: Plan, mi: int) -> np.ndarray:
    if f"dft{mi}:w" in plan.coefs:
        return np.asarray(plan.coefs[f"dft{mi}:w"])
    return (np.asarray(plan.coefs[f"dft{mi}:wre"])
            + 1j * np.asarray(plan.coefs[f"dft{mi}:wim"]))


class TwoRunGradient:
    """Forward/adjoint-run gradient engine over a compiled plan.

    Parameters
    ----------
    plan : the simulation's compiled plan (real fields).
    design_entries : {key: (component, ((lo, hi), ...))} raw-lattice slices
        per design-region/component pair (from DesignRegion._site_maps; the
        key is free-form, e.g. "0:ez" for region 0's ez sites).
    nsteps : steps per run (both runs must be decayed at the end).
    adjoint_fwidth_frac : Gaussian fwidth of the adjoint pulse as a
        fraction of each objective frequency.
    """

    def __init__(self, plan: Plan, design_entries: Dict[str, Tuple],
                 nsteps: int, adjoint_fwidth_frac: float = 0.2):
        if plan.complex_fields:
            raise NotImplementedError(
                "two-run adjoint: real-field plans only (use jax.grad for "
                "Bloch/complex runs)")
        if plan.gv.dim == "cyl":
            raise NotImplementedError("two-run adjoint: cartesian only")
        self.plan = plan
        self.nsteps = nsteps
        self.fwidth_frac = adjoint_fwidth_frac
        self.design_entries = dict(design_entries)
        # all monitor frequencies (the adjoint loop skips those with a
        # zero cotangent at runtime)
        freqs = sorted({float(f) for m in plan.dfts for f in m.freqs})
        self.freqs = np.array(freqs)
        self._fidx = {f: i for i, f in enumerate(freqs)}
        # forward plan = user plan + per-design-entry DFTs
        self._dr_names = {}
        dr_dfts = []
        for key, (c, slices) in self.design_entries.items():
            name = f"adjdr:{key}"
            self._dr_names[key] = name
            shape = tuple(b - a for a, b in slices)
            dr_dfts.append(DftSpec(
                name=name, component=c, region=tuple(slices),
                weights=np.ones(shape), freqs=self.freqs, centered=False))
        self.plan_fwd = plan_with(plan, dfts=list(plan.dfts) + dr_dfts)
        self._adj_cache: Dict[Any, Plan] = {}
        self._decay_pending: List[Tuple[str, Any, Any]] = []
        # adjoint sources must not sit on conductive sites: the compiled
        # plan does not retain the material cond rows, so plan_with
        # cannot rebuild the step.cpp:300-309 source rescaling
        if any(getattr(s_, "has_cond", False)
               for s_ in (list(plan.curl_specs_d) + list(plan.curl_specs_b)
                          + list(plan.eh_specs_e) + list(plan.eh_specs_h))) \
                or any(k.endswith(":cndinv") for k in plan.coefs):
            raise NotImplementedError(
                "two-run adjoint on a plan with D/B conductivities: the "
                "adjoint sources cannot rebuild the conductive-site "
                "rescaling (sources.cpp:300) — use gradient_method='ad'")

    def _run_checked(self, plan: Plan, nsteps: int, label: str):
        """Run in two halves, recording DEVICE-side |f|max at T/2 and T
        for the decay check: the pairing identity is exact only in the
        decayed-run limit (the same caveat as the reference's adjoint
        solver, which likewise truncates the time integrals; e.g. a
        random high-epsilon design can trap quasi-bound states with
        Q >> run length).  The maxima stay on the device until
        _flush_decay_checks reads them at the end of the gradient call."""
        half = nsteps // 2
        state = S.init_state(plan)
        state = S.run(plan, state, half, t0=0)
        mid = jnp.stack([jnp.max(jnp.abs(state["f"][c]))
                         for c in state["f"]]).max()
        state = S.run(plan, state, nsteps - half, t0=half)
        end = jnp.stack([jnp.max(jnp.abs(state["f"][c]))
                         for c in state["f"]]).max()
        self._decay_pending.append((label, mid, end))
        return state

    def _flush_decay_checks(self):
        import warnings
        pending, self._decay_pending = self._decay_pending, []
        for label, mid_dev, end_dev in pending:
            mid, end = float(mid_dev), float(end_dev)
            if end > 1e-6 and end > 0.05 * mid:
                warnings.warn(
                    f"two-run adjoint: {label} run not decayed "
                    f"(|f|max {mid:.2e} at T/2 -> {end:.2e} at T); the "
                    "paired gradient carries a truncation error of that "
                    "order -- increase run_time", stacklevel=3)

    # -- forward ----------------------------------------------------------
    def forward(self, coefs: Dict[str, Any]) -> Dict[str, Any]:
        self.plan_fwd.coefs = {**self.plan_fwd.coefs,
                               **{k: v for k, v in coefs.items()
                                  if not _SRC_DFT_KEY.match(k)}}
        state = self._run_checked(self.plan_fwd, self.nsteps, "forward")
        return state["dft"]

    # -- cotangents -------------------------------------------------------
    @staticmethod
    def cotangents(objective: Callable, dfts: Dict[str, Any]):
        """(J, {name: complex cotangent}) for an objective over the complex
        accumulator views.

        Only the user-visible monitor accumulators are exposed to the
        objective — the engine's internal adjdr:* design-region DFTs are
        hidden so an objective that iterates the dict sees the same
        entries as gradient_method='ad'."""
        mon = {k: v for k, v in dfts.items() if not k.startswith("adjdr:")}

        def J_raw(raw):
            return objective({k: S.dft_view(v) for k, v in raw.items()})

        Jval, cot = jax.value_and_grad(J_raw)(mon)
        C = {k: np.asarray(v[..., 0]) - 1j * np.asarray(v[..., 1])
             for k, v in cot.items()}
        return float(Jval), C

    # -- adjoint ----------------------------------------------------------
    def _amp_grids(self, C: Dict[str, np.ndarray], freq: float):
        """Per-monitor adjoint amplitude grids at one frequency (FIXED
        site structure — all region sites — so the cached jitted adjoint
        runner is reused across optimization iterations)."""
        out = {}
        for mi, m in enumerate(self.plan.dfts):
            fa = np.asarray(m.freqs)
            fi = int(np.argmin(np.abs(fa - freq)))
            if abs(float(fa[fi]) - freq) > 1e-12:
                continue
            cot = C.get(m.name)
            # C = dJ/d acc_re - i dJ/d acc_im is ALREADY the complex source
            # amplitude: the objective drive is w*s*Re[C e^{i w t}]
            cgrid = (cot[..., fi] if cot is not None
                     else np.zeros(tuple(b - a for a, b in m.region),
                                   np.complex128))
            amp = cgrid * _monitor_coef_weights(self.plan, mi) * m.scale
            if m.component[0] in ("h", "b"):
                amp = -amp              # Z_h = -Z_e
            out[mi] = amp
        return out

    def _adjoint_plan(self, freq: float):
        """Cached adjoint-plan skeleton for one frequency: sources at
        every site of every monitor carrying this frequency (amps are
        runner arguments via coefs, updated per call without retracing)."""
        key = float(freq)
        entry = self._adj_cache.get(key)
        if entry is not None:
            return entry
        st = GaussianSource(frequency=freq,
                            fwidth=max(self.fwidth_frac * freq, 1e-6))
        srcs, order = [], []
        zero = {mi: np.zeros_like(a)
                for mi, a in self._amp_grids({}, freq).items()}
        for mi, amp in zero.items():
            m = self.plan.dfts[mi]
            idx, _ = _spread_centered(self.plan, m,
                                      np.ones_like(amp))
            srcs.append(SrcVolSpec(
                component=m.component, indices=idx,
                amps=np.zeros(len(idx), np.complex128), src_time=st))
            order.append(mi)
        dr_dfts = [s for s in self.plan_fwd.dfts
                   if s.name.startswith("adjdr:")]
        plan_adj = plan_with(self.plan, sources=srcs, dfts=dr_dfts)
        entry = (plan_adj, st, order)
        self._adj_cache[key] = entry
        return entry

    def _adjoint_plan_broadband(self):
        """Cached single broadband adjoint-plan skeleton: one tone basis
        source PER (monitor, objective frequency).  The tone matrix
        M[i, j] = ghat_j(f_i) is inverted so the combined drive has EXACT
        per-frequency amplitudes at every objective frequency (the role
        of the reference's FilteredSource, adjoint/filter_source.py —
        here solved exactly in the tone basis instead of fitting a
        windowed-sinc FIR)."""
        entry = self._adj_cache.get("broadband")
        if entry is not None:
            return entry
        freqs = [float(f) for f in self.freqs]
        spacing = (min(np.diff(freqs)) if len(freqs) > 1
                   else self.fwidth_frac * freqs[0])
        tones = [GaussianSource(frequency=f,
                                fwidth=max(min(spacing,
                                               self.fwidth_frac * f), 1e-6))
                 for f in freqs]
        M = np.array([[_src_spectrum(tj, fi, self.nsteps, self.plan.dt)
                       for tj in tones] for fi in freqs])
        # EVERY monitor gets a tone at EVERY objective frequency: the
        # per-monitor solve must cancel each tone's spectral leakage at
        # the frequencies the monitor does NOT carry (its desired
        # amplitude there is zero), which needs the full basis per
        # monitor even when monitors carry different frequency subsets
        monitors_all = sorted({mi for f in freqs
                               for mi in self._amp_grids({}, f)})
        srcs, order = [], []
        for j, tone in enumerate(tones):
            for mi in monitors_all:
                m = self.plan.dfts[mi]
                amp0 = np.zeros(tuple(b - a for a, b in m.region))
                idx, _ = _spread_centered(self.plan, m,
                                          np.ones_like(amp0))
                srcs.append(SrcVolSpec(
                    component=m.component, indices=idx,
                    amps=np.zeros(len(idx), np.complex128), src_time=tone))
                order.append((j, mi))
        dr_dfts = [s for s in self.plan_fwd.dfts
                   if s.name.startswith("adjdr:")]
        plan_adj = plan_with(self.plan, sources=srcs, dfts=dr_dfts)
        entry = (plan_adj, np.linalg.inv(M), np.linalg.cond(M), order)
        self._adj_cache["broadband"] = entry
        return entry

    def _pair_accumulate(self, st2, g, Ehat, live_freqs):
        """Add Re[Z (Lam) Ehat]/u^2 for each live frequency; Lam must
        already carry unit drive at each objective frequency."""
        dt = self.plan.dt
        for freq in live_freqs:
            Z = _Z_e(float(freq), dt)
            fidx = self._fidx[float(freq)]
            for key, name in self._dr_names.items():
                c, slices = self.design_entries[key]
                Lam = np.asarray(S.dft_view(
                    np.asarray(st2["dft"][name])))[..., fidx]
                sl = tuple(slice(a, b) for a, b in slices)
                u_row = self.plan_fwd.coefs.get(f"{c}:u")
                u_sl = np.asarray(u_row)[sl] if u_row is not None else 1.0
                g[key] += np.real(Z * Lam
                                  * Ehat[key][..., fidx]) / u_sl ** 2

    def gradient(self, objective: Callable, coefs: Dict[str, Any]):
        """(J, {design key: dJ/du_c over that entry's design slices})."""
        dfts = self.forward(coefs)
        J, C = self.cotangents(objective, dfts)
        Ehat = {k: np.asarray(S.dft_view(np.asarray(dfts[n])))
                for k, n in self._dr_names.items()}
        g = {k: np.zeros(E.shape[:-1], np.float64)
             for k, E in Ehat.items()}
        amps_per_f = {float(f): self._amp_grids(C, float(f))
                      for f in self.freqs}
        live = [f for f, amps in amps_per_f.items()
                if amps and any(np.any(a) for a in amps.values())]
        if not live:
            self._flush_decay_checks()
            return J, g
        if len(live) > 1:
            plan_adj, Minv, condM, order = self._adjoint_plan_broadband()
            if condM < 1e9:
                self._gradient_broadband(coefs, amps_per_f, live,
                                         plan_adj, Minv, order, g, Ehat)
                self._flush_decay_checks()
                return J, g
            # ill-conditioned tone basis (near-degenerate frequency
            # grid): fall back to one adjoint run per frequency
        self._gradient_perfreq(coefs, amps_per_f, live, g, Ehat)
        self._flush_decay_checks()
        return J, g

    def _gradient_broadband(self, coefs, amps_per_f, live, plan_adj, Minv,
                            order, g, Ehat):
        """ONE adjoint run covering every objective frequency."""
        freqs = [float(f) for f in self.freqs]
        spread = {}
        for f in freqs:
            spread[f] = {}
            for mi, amp in amps_per_f[f].items():
                m = self.plan.dfts[mi]
                _, avals = _spread_centered(self.plan, m, amp,
                                            keep_zeros=True)
                spread[f][mi] = avals
        newc = dict(plan_adj.coefs)
        for si, (j, mi) in enumerate(order):
            # tone j carries sum_i Minv[j, i] * A(f_i) at monitor mi
            avals = sum(Minv[j, i] * spread[fi][mi]
                        for i, fi in enumerate(freqs)
                        if mi in spread[fi])
            if np.isscalar(avals):       # monitor absent at all freqs
                avals = np.zeros(
                    len(np.asarray(newc[f"src{si}:amp_re"])), complex)
            newc[f"src{si}:amp_re"] = avals.real.astype(self.plan.dtype)
            newc[f"src{si}:amp_im"] = avals.imag.astype(self.plan.dtype)
        for k, v in coefs.items():
            if not _SRC_DFT_KEY.match(k):
                newc[k] = v
        plan_adj.coefs = newc
        st2 = self._run_checked(plan_adj, self.nsteps, "adjoint(broadband)")
        self._pair_accumulate(st2, g, Ehat, live)

    def _gradient_perfreq(self, coefs, amps_per_f, live, g, Ehat):
        """One adjoint run per objective frequency (exact regardless of
        tone-basis conditioning)."""
        dt = self.plan.dt
        for freq in live:
            amps = amps_per_f[freq]
            plan_adj, st, order = self._adjoint_plan(float(freq))
            shat = _src_spectrum(st, float(freq), self.nsteps, dt)
            newc = dict(plan_adj.coefs)
            for si, mi in enumerate(order):
                m = self.plan.dfts[mi]
                _, avals = _spread_centered(self.plan, m,
                                            amps[mi] / shat,
                                            keep_zeros=True)
                newc[f"src{si}:amp_re"] = avals.real.astype(self.plan.dtype)
                newc[f"src{si}:amp_im"] = avals.imag.astype(self.plan.dtype)
            for k, v in coefs.items():
                if not _SRC_DFT_KEY.match(k):
                    newc[k] = v
            plan_adj.coefs = newc
            st2 = self._run_checked(plan_adj, self.nsteps,
                                    f"adjoint(f={freq:g})")
            self._pair_accumulate(st2, g, Ehat, [freq])
