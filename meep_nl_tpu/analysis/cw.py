"""Frequency-domain CW solver (analog of src/cw_fields.cpp:142 solve_cw +
src/bicgstab.cpp).

The steady state of a CW-driven linear system satisfies
    x_{n+1} = A x_n + b   with   x_{n+1} = lambda x_n,  lambda = e^{-i w dt}
i.e. the linear system (A - lambda I) x = -b, where A is ONE timestep with
sources off (a pure linear operator on the complex field state) and b is one
timestep applied to the zero state with sources on.  The reference builds the
same operator out of fields::step and solves with BiCGSTAB(L); here the
operator is the jitted step and the solver is a pytree-valued BiCGSTAB
running entirely on device (dot products are the reference's sum_to_all
reductions, performed by XLA).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..stepper.plan import Plan
from ..stepper.step import build_xs, init_state, make_step


def _tree_dot(a, b):
    leaves = jax.tree.leaves(jax.tree.map(
        lambda x, y: jnp.sum(jnp.conj(x) * y), a, b))
    return sum(leaves)


def _tree_axpy(alpha, x, y):
    return jax.tree.map(lambda xi, yi: alpha * xi + yi, x, y)


def _tree_scale(alpha, x):
    return jax.tree.map(lambda xi: alpha * xi, x)


def bicgstab_tree(op: Callable, b, x0, tol: float = 1e-8,
                  max_iters: int = 2000):
    """Unpreconditioned BiCGSTAB on pytree vectors (bicgstab.cpp analog)."""
    r0 = jax.tree.map(lambda bi, axi: bi - axi, b, op(x0))
    rhat = r0

    def norm(v):
        return jnp.sqrt(jnp.abs(_tree_dot(v, v)))

    bnorm = norm(b)

    def cond(carry):
        x, r, p, v, rho, alpha, omega, k = carry
        return jnp.logical_and(k < max_iters, norm(r) > tol * bnorm)

    def body(carry):
        x, r, p, v, rho, alpha, omega, k = carry
        rho1 = _tree_dot(rhat, r)
        beta = (rho1 / rho) * (alpha / omega)
        p = _tree_axpy(beta, _tree_axpy(-omega, v, p), r)
        v = op(p)
        alpha = rho1 / _tree_dot(rhat, v)
        s = _tree_axpy(-alpha, v, r)
        t = op(s)
        omega = _tree_dot(t, s) / _tree_dot(t, t)
        x = _tree_axpy(alpha, p, _tree_axpy(omega, s, x))
        r = _tree_axpy(-omega, t, s)
        return (x, r, p, v, rho1, alpha, omega, k + 1)

    one = jnp.asarray(1.0 + 0j, jnp.complex64)
    zeros = jax.tree.map(jnp.zeros_like, b)
    carry = (x0, r0, zeros, zeros, one, one, one, jnp.asarray(0))
    carry = jax.lax.while_loop(cond, body, carry)
    x, r = carry[0], carry[1]
    return x, norm(r) / bnorm, carry[7]


def _build_ops(plan: Plan, freq: float, m: int):
    """Shared machinery: the m-step shifted operator (A^m - lambda^m) and
    the driven right-hand side, on the packed linear substate."""
    if not plan.complex_fields:
        raise ValueError("frequency-domain solves need complex fields "
                         "(compile_plan(complex_fields=True))")
    step = make_step(plan)
    xs_m = build_xs(plan, m, 0)
    xs0 = {k: jnp.zeros_like(v[0]) for k, v in xs_m.items()}
    lam_m = jnp.exp(-2j * np.pi * freq * plan.dt * m).astype(jnp.complex64)

    z0 = init_state(plan)
    # the full linear substate: fields plus every auxiliary (PML fu/fcnd/W,
    # polarization P/P_prev) --- they are all part of the one-step linear
    # recurrence (the reference instead eliminates W algebraically via
    # set_solve_cw_omega, meep.hpp:1569)
    LIN_KEYS = tuple(k for k in ("f", "f_u", "f_cond", "f_w", "pol",
                                 "d_sl", "fu_sl", "fw_sl") if k in z0)

    def pack(state):
        return {k: state[k] for k in LIN_KEYS}

    def unpack(x):
        return {**z0, **x}

    @jax.jit
    def op(x, C):
        """(A^m - lambda^m) x : m sourceless steps minus the phase advance."""
        s = unpack(x)
        for _ in range(m):
            s = step(s, xs0, C)
        return jax.tree.map(lambda a, b: a - lam_m * b, pack(s), x)

    @jax.jit
    def rhs(C):
        """-(m driven steps from zero): the source contribution, with the
        per-substep time phases from build_xs."""
        s = z0
        for j in range(m):
            s = step(s, {k: v[j] for k, v in xs_m.items()}, C)
        return jax.tree.map(lambda a: -a, pack(s))

    return op, rhs, lam_m


def solve_cw(plan: Plan, freq: float, tol: float = 1e-6,
             max_iters: int = 2000, m: int = 8) -> Dict[str, Any]:
    """Solve for the complex steady-state fields at `freq` (solve_cw,
    cw_fields.cpp:142).  Requires plan.complex_fields.

    Uses the m-step operator (A^m - lambda^m): the one-step operator's
    spectrum hugs the unit circle (unitary propagation), which stalls
    unpreconditioned Krylov; m steps per application widens the spectral
    gaps --- the matrix-free stand-in for the reference's BiCGSTAB(L)
    polynomial smoothing (bicgstab.cpp L=2)."""
    op, rhs, _ = _build_ops(plan, freq, m)
    C = plan.coefs
    b = rhs(C)
    x0 = jax.tree.map(jnp.zeros_like, b)
    x, relres, iters = bicgstab_tree(partial(op, C=C), b, x0, tol=tol,
                                     max_iters=max_iters)
    return {**x, "relres": float(jax.device_get(relres)),
            "iters": int(jax.device_get(iters))}


def solve_eigfreq(plan: Plan, freq_guess: float, eig_tol: float = 1e-6,
                  eig_iters: int = 12, cw_tol: float = 1e-8,
                  cw_iters: int = 4000, m: int = 8) -> Dict[str, Any]:
    """Frequency-domain eigensolver: the resonant mode nearest `freq_guess`
    by shift-invert power iteration on the m-step operator (the reference's
    solve_cw-based eigensolver; cw_fields.cpp + SURVEY 2 'frequency-domain
    eigensolver via shift-invert iterations').

    Each iteration solves (A^m - sigma^m) w = v with BiCGSTAB, the inverse
    iteration for the eigenvalue lambda^m of A^m closest to
    sigma^m = e^{-i 2 pi f0 dt m}; the Rayleigh quotient mu = <v, w> gives
    lambda^m = sigma^m + 1/mu.  Returns the complex eigenfrequency
    (freq_re, decay rate, Q) and the mode fields."""
    op, rhs, sigma_m = _build_ops(plan, freq_guess, m)
    C = plan.coefs

    def norm(v):
        return jnp.sqrt(jnp.abs(_tree_dot(v, v)))

    # seed: a few driven steps imprint the source's spatial structure
    v = rhs(C)
    v = _tree_scale(1.0 / norm(v), v)
    lam_prev = None
    lam_m = None
    history = []
    for _ in range(eig_iters):
        w, relres, _ = bicgstab_tree(partial(op, C=C), v,
                                     jax.tree.map(jnp.zeros_like, v),
                                     tol=cw_tol, max_iters=cw_iters)
        mu = jax.device_get(_tree_dot(v, w))       # <v, w>, ||v|| = 1
        lam_m = complex(jax.device_get(sigma_m)) + 1.0 / complex(mu)
        v = _tree_scale(1.0 / norm(w), w)
        history.append(lam_m)
        # the first iterates mix non-normal (PML) transients into the
        # Rayleigh quotient; never trust agreement before iteration 3
        if len(history) >= 3 and lam_prev is not None and \
                abs(lam_m - lam_prev) <= eig_tol * abs(lam_m):
            break
        lam_prev = lam_m
    # lambda^m = e^{-i omega m dt}: unwrap around the guess (principal
    # branch of log(lam/sigma) stays near zero)
    w0 = 2 * np.pi * freq_guess
    omega = w0 + 1j * np.log(lam_m / complex(jax.device_get(sigma_m))) \
        / (m * plan.dt)
    freq = omega / (2 * np.pi)
    decay = -2 * np.pi * freq.imag   # field amplitude decay rate Im(omega)
    Q = float(freq.real / (2 * abs(freq.imag))) if freq.imag != 0 else \
        np.inf
    return {"freq": float(freq.real), "decay": float(decay), "Q": Q,
            "eigfreq": complex(freq), "mode": v,
            "iters": len(history), "history": history}
