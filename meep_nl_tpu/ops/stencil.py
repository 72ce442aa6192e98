"""Shifted-slice stencil primitives.

The analog of the reference's strided pointer walks (`g1[i + s1]` in
step_generic.cpp:69) expressed as whole-array shifts that XLA fuses into the
surrounding elementwise update.  Out-of-range neighbors are zero (the PEC /
not-owned convention) unless the axis is Bloch-periodic, in which case the
wrapped plane is multiplied by the Bloch phase (the CONNECT_PHASE class of
boundaries.cpp:347).

Arrays may carry dead storage padding past the live region (for shard
divisibility); `nlive` is the number of live cells along the
axis (the periodic wrap distance).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp


def _cmul_pair(arr: jnp.ndarray, ph: complex) -> jnp.ndarray:
    """Multiply a channel-stacked real pair (leading axis 0 = re/im) by a
    complex scalar, staying entirely in real arithmetic."""
    a, b = float(ph.real), float(ph.imag)
    re, im = arr[0], arr[1]
    return jnp.stack([a * re - b * im, b * re + a * im])


def shift(arr: jnp.ndarray, axis: int, by: int,
          periodic: bool = False, phase=None,
          nlive: Optional[int] = None, pair: bool = False) -> jnp.ndarray:
    """Return out with out[i] = arr[i + by] along `axis` (by in {-1, +1}).

    Non-periodic: vacated entries are zero.
    Periodic: live cells are 0..nlive-1 (indices >= nlive are dead ghosts,
    masked upstream); wrapping applies `phase` (exp(+-i k L)).

    pair=True: `arr` carries complex data as a stacked real pair on axis 0
    (re, im); the wrap phase is applied as a real 2x2 rotation.
    """
    if by == 0:
        return arr
    sdim = arr.shape[axis]

    def sl(a, b):
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(a, b)
        return tuple(idx)

    if not periodic:
        pad = [(0, 0)] * arr.ndim
        if by > 0:
            pad[axis] = (0, by)
            return jnp.pad(arr[sl(by, None)], pad)
        else:
            pad[axis] = (-by, 0)
            return jnp.pad(arr[sl(None, by)], pad)

    n = nlive if nlive is not None else sdim - 1

    def mul_phase(seg, ph):
        if ph is None:
            return seg
        if pair:
            if isinstance(ph, complex) and ph.imag != 0.0:
                return _cmul_pair(seg, ph)
            return seg * (ph.real if isinstance(ph, complex) else ph)
        return seg * ph

    # periodic: roll the live cells, phase the wrapped plane, keep dead
    # storage (indices >= n) zero.
    live = arr[sl(0, n)]
    rolled = jnp.roll(live, -by, axis=axis)
    if by > 0:
        head = mul_phase(rolled[sl(n - by, n)], phase)
        rolled = jnp.concatenate([rolled[sl(0, n - by)], head], axis=axis)
    else:
        inv = None if phase is None else 1.0 / phase
        tail = mul_phase(rolled[sl(0, -by)], inv)
        rolled = jnp.concatenate([tail, rolled[sl(-by, n)]], axis=axis)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, sdim - n)
    return jnp.pad(rolled, pad)
