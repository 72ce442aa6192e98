"""Inverse design via native autodiff through the time stepper.

The reference drives an explicit forward-run / adjoint-run pair with
hand-derived adjoint sources (python/adjoint/optimization_problem.py:159,
create_adjoint_sources utils.py:221) and a C++ gradient kernel
(material_grids_addgradient, meepgeom.cpp:2829).  Here the entire chain

    rho -> (projection/interp) -> inverse-eps coefs -> lax.scan time loop
        -> DTFT monitors -> objective

is one pure JAX function, so jax.grad produces the same gradient with a
single reverse pass.  Memory is bounded with two-level scan rematerialization
(outer blocks checkpointed, inner steps recomputed in the backward sweep) --
the array-program analog of the adjoint run's storage trade-off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..stepper.plan import Plan
from ..stepper.step import build_xs, init_state, make_step
from .design import DesignRegion


def _split_blocks(nsteps: int, block: Optional[int]) -> int:
    if block is None:
        block = max(1, int(math.sqrt(nsteps)))
    while nsteps % block:
        block -= 1
    return block


def run_differentiable(plan: Plan, nsteps: int, coefs: Dict[str, Any],
                       state: Optional[Dict[str, Any]] = None,
                       block: Optional[int] = None, t0: int = 0):
    """Differentiable scan of the step with O(sqrt(T)) checkpointing.

    Returns the final state; grad flows into `coefs` (and the initial state).
    """
    step = make_step(plan)
    if state is None:
        state = init_state(plan)
    xs = build_xs(plan, nsteps, t0)
    block = _split_blocks(nsteps, block)
    nblocks = nsteps // block
    xs_blocked = jax.tree.map(
        lambda a: a.reshape((nblocks, block) + a.shape[1:]), xs)

    @jax.checkpoint
    def block_fn(carry, xs_blk):
        def body(c, x):
            return step(c, x, coefs), None
        c2, _ = jax.lax.scan(body, carry, xs_blk, length=block)
        return c2, None

    state, _ = jax.lax.scan(block_fn, state, xs_blocked, length=nblocks)
    return state


@dataclasses.dataclass
class OptimizationProblem:
    """Topology-optimization driver (optimization_problem.py:12 analog).

    simulation: a configured (not yet run) Simulation whose geometry contains
      a placeholder block covering each design region (so the inverse-eps
      rows exist in the compiled plan).
    objective: callable(state_dft: dict) -> scalar, built from the monitor
      DTFT accumulators (the analog of ObjectiveQuantity evaluation).
    design_regions: DesignRegion list (bound automatically).
    nsteps / run_time: duration of the forward run.
    """
    simulation: Any
    objective: Optional[Callable[[Dict[str, Any]], jnp.ndarray]] = None
    design_regions: Optional[List[DesignRegion]] = None
    run_time: Optional[float] = None
    block: Optional[int] = None
    # reference-signature alternative (optimization_problem.py:12):
    # objective_functions over ObjectiveQuantity values, a frequency
    # list, and a run bound — translated to the native form below
    objective_functions: Optional[Sequence[Callable]] = None
    objective_arguments: Optional[Sequence[Any]] = None
    frequencies: Optional[Sequence[float]] = None
    fcen: Optional[float] = None
    df: Optional[float] = None
    nf: int = 1
    maximum_run_time: Optional[float] = None
    decay_by: float = 1e-11
    minimum_run_time: float = 0.0
    finite_difference_step: float = 1e-3
    # "ad": native jax.grad through the lax.scan time loop (exact, jnp
    #   stepper, sqrt-T remat).  "pair": physical forward/adjoint run pair
    #   through the production fast path (adjoint/tworun.py — the
    #   reference's two-run structure, optimization_problem.py:159).
    gradient_method: str = "ad"
    adjoint_fwidth_frac: float = 0.2

    def __post_init__(self):
        sim = self.simulation
        # reference-style construction: register the objective monitors
        # BEFORE the plan is built, then compose the dft-dict objective
        # from the objective functions over the quantities' values
        if self.objective is None and self.objective_functions:
            from .compat import ObjectiveQuantity
            if self.frequencies is None:
                fc = self.fcen if self.fcen is not None else 1.0
                dfv = self.df if self.df is not None else 0.0
                self.frequencies = (
                    [fc] if self.nf == 1
                    else np.linspace(fc - dfv / 2, fc + dfv / 2, self.nf))
            quantities = list(self.objective_arguments or [])
            for q in quantities:
                if isinstance(q, ObjectiveQuantity) and q._handle is None:
                    q.register_monitors(self.frequencies)
            if self.run_time is None:
                last = max((s.src.last_time() for s in sim.sources),
                           default=0.0)
                extra = self.maximum_run_time \
                    if self.maximum_run_time is not None else 100.0
                self.run_time = last + float(extra)
            fns_cell = {}

            def composed(dfts):
                if "fns" not in fns_cell:
                    fns_cell["fns"] = [
                        q.make_fn() if isinstance(q, ObjectiveQuantity)
                        else q for q in quantities]
                vals = [fn(dfts) for fn in fns_cell["fns"]]
                outs = [f(*vals) for f in self.objective_functions]
                return outs[0] if len(outs) == 1 else jnp.stack(
                    [jnp.asarray(o) for o in outs])
            self.objective = composed
        if self.design_regions is None:
            self.design_regions = []
        if self.run_time is None:
            raise ValueError("OptimizationProblem needs run_time (or "
                             "objective_functions + maximum_run_time)")
        damped = [dr for dr in self.design_regions
                  if float(getattr(dr.variables, "damping", 0.0))]
        if damped:
            # MaterialGrid damping writes sigma = damping*u*(1-u) into
            # the D-conductivity coefficient rows at apply() time
            # (meepgeom.cpp:623-626); the plan must be compiled with
            # those rows present (structural has_cond), so force them in
            # before the plan exists
            sim._force_cond_d = getattr(sim, "_force_cond_d", set()) \
                | {"dx", "dy", "dz"}
        sim.init_sim()
        self.plan = sim.plan
        live_e = [s.ec for s in self.plan.eh_specs_e]
        for dr in self.design_regions:
            dr.bind(self.plan.gv, live_e)
            if float(getattr(dr.variables, "damping", 0.0)):
                missing = [c for c in dr._site_maps
                           if f"d{c[1]}:cnd" not in self.plan.coefs]
                if missing:
                    raise ValueError(
                        "MaterialGrid damping != 0 but the Simulation "
                        "was initialized without conductivity rows for "
                        f"{missing}; construct the OptimizationProblem "
                        "before running/init_sim")
            for c in dr._site_maps:
                if f"{c}:u" not in self.plan.coefs:
                    raise ValueError(
                        f"plan has no inverse-eps row for {c}; include a "
                        "placeholder block over the design region so the "
                        "epsilon coefficients exist")
        self.nsteps = int(round(self.run_time / self.plan.dt))
        if self.gradient_method == "pair":
            from .tworun import TwoRunGradient
            entries = {}
            for ri, dr in enumerate(self.design_regions):
                for c, (slices, _fracs) in dr._site_maps.items():
                    entries[f"{ri}:{c}"] = (c, slices)
            self._engine = TwoRunGradient(
                self.plan, entries, self.nsteps,
                adjoint_fwidth_frac=self.adjoint_fwidth_frac)

        def J(*rhos):
            coefs = self.plan.coefs
            for dr, rho in zip(self.design_regions, rhos):
                coefs = dr.apply(rho, coefs, self.plan)
            state = run_differentiable(self.plan, self.nsteps, coefs,
                                       block=self.block)
            from ..stepper.step import dft_view
            dfts = {k: dft_view(v) for k, v in state["dft"].items()}
            # dfts ride along as aux so reference-style ObjectiveQuantity
            # instances can report get_evaluation() after a call
            return self.objective(dfts), dfts

        self._J = jax.jit(lambda *r: J(*r)[0])   # scalar-only (composable)
        self._J_aux = jax.jit(J)                 # (scalar, dfts)
        if self.gradient_method != "pair":
            self._vg = jax.jit(jax.value_and_grad(J, argnums=tuple(
                range(len(self.design_regions))), has_aux=True))

    def _pair_call(self, *rhos):
        """Forward/adjoint-pair evaluation: J and per-region rho gradient
        (pairing identity + VJP through the density->inverse-eps map)."""
        coefs = self.plan.coefs
        for dr, rho in zip(self.design_regions, rhos):
            coefs = dr.apply(rho, coefs, self.plan)
        Jval, g_u = self._engine.gradient(self.objective, coefs)
        grads = []
        for ri, (dr, rho) in enumerate(zip(self.design_regions, rhos)):
            comps = list(dr._site_maps)

            def u_of_rho(r, dr=dr, comps=comps):
                return {c: 1.0 / dr.eps_at_sites(r, c) for c in comps}

            primal, vjp = jax.vjp(u_of_rho, rho)
            cot = {c: jnp.asarray(g_u[f"{ri}:{c}"], primal[c].dtype)
                   for c in comps}
            grads.append(np.asarray(vjp(cot)[0]))
        return Jval, grads

    def __call__(self, *rhos, need_gradient: bool = True):
        if not rhos:
            # reference opt(): evaluate at the design regions' current
            # MaterialGrid weights
            rhos = []
            for dr in self.design_regions:
                w = getattr(dr.variables, "weights", None)
                if w is None:
                    raise ValueError(
                        "no design variables passed and the design "
                        "region's MaterialGrid has no weights")
                rhos.append(np.asarray(w, np.float64).reshape(
                    dr.variables.shape))
        rhos = [jnp.asarray(r) for r in rhos]
        if need_gradient:
            if self.gradient_method == "pair":
                f0, grads = self._pair_call(*rhos)
                return np.asarray(f0), grads
            (f0, dfts), grads = self._vg(*rhos)
            self._stash_quantity_values(dfts)
            return np.asarray(f0), [np.asarray(g) for g in grads]
        f0, dfts = self._J_aux(*rhos)
        self._stash_quantity_values(dfts)
        return np.asarray(f0), None

    def _stash_quantity_values(self, dfts):
        """Record each reference-style ObjectiveQuantity's value from the
        run's DTFTs so get_evaluation() works after a call."""
        if not self.objective_arguments:
            return
        from .compat import ObjectiveQuantity
        for q in self.objective_arguments:
            if isinstance(q, ObjectiveQuantity):
                q._eval = np.asarray(q.make_fn()(dfts))

    def calculate_fd_gradient(self, rho, idx, drho=1e-4, region: int = 0):
        """Central finite difference for one density entry (the validation
        tool of optimization_problem.py:395)."""
        rho = np.asarray(rho, np.float64)
        rp = rho.copy(); rp[idx] += drho
        rm = rho.copy(); rm[idx] -= drho
        fp, _ = self(jnp.asarray(rp), need_gradient=False)
        fm, _ = self(jnp.asarray(rm), need_gradient=False)
        return (fp - fm) / (2 * drho)
