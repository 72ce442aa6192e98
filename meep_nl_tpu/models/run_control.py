"""Run-control DSL: step-function combinators and stop conditions
(analog of python/simulation.py:4991-5445).

Compiled-loop adaptation: python callbacks cannot run inside the compiled scan, so the
runner splits the time loop into jitted blocks and invokes callbacks at block
boundaries (every `dt` time units); Harminv-style collectors instead ride the
scan as probe outputs (stepper.step ProbeSpec) and never leave the device
mid-run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class StepFuncs:
    """Parsed step functions for one run() invocation."""
    every: List          # (interval_time, fn)
    begin: List
    end: List
    after_sources_fns: List
    collectors: List     # Harminv-likes: (obj, only_after_sources)


def at_every(dt: float, *fns):
    """Apply fns every dt time units (simulation.py at_every)."""
    return ("at_every", dt, fns)


def at_beginning(*fns):
    return ("at_beginning", fns)


def at_end(*fns):
    return ("at_end", fns)


def after_sources_marker(fns):
    return ("after_sources", fns)


def during_sources(*fns):
    return ("during_sources", fns)


def in_volume(volume, *fns):
    """Restrict output functions to a volume (wraps fn with a region)."""
    def wrap(fn):
        def inner(sim):
            return fn(sim, volume=volume)
        return inner
    return ("at_every", 0.0, tuple(wrap(f) for f in fns))


@dataclasses.dataclass
class stop_when_fields_decayed:
    """Stop condition: |component|^2 at pt decayed by decay_by from its peak
    (simulation.py:5225).  Matching the reference, the decision uses the MAX
    of |f|^2 over each dt window — never a single instantaneous sample, which
    could land on a zero crossing of the oscillating field and terminate the
    run prematurely.  The runner rides an in-scan probe at pt so every
    timestep inside the window is sampled (the reference samples every step
    via its per-step closure)."""
    dt: float
    c: str
    pt: Any
    decay_by: float = 1e-3
    _peak: float = 0.0

    def check_window(self, window_max_abs: float) -> bool:
        """Decide from the max |f| over the past dt window (probe-fed)."""
        cur = float(window_max_abs) ** 2
        self._peak = max(self._peak, cur)
        return self._peak > 0 and cur <= self.decay_by * self._peak

    def check(self, sim) -> bool:
        # fallback (no probe available): instantaneous sample
        return self.check_window(abs(sim.get_field_point(self.c, self.pt)))


@dataclasses.dataclass
class stop_when_dft_decayed:
    """Stop when all DFT accumulators stop changing relative to their norms
    (simulation.py:5357)."""
    tol: float = 1e-6
    minimum_run_time: float = 0.0
    maximum_run_time: float = 1e20
    dt: float = 4.0
    _prev: Optional[dict] = None

    def check(self, sim) -> bool:
        import jax
        cur = {k: np.asarray(jax.device_get(v))
               for k, v in sim.fields_state["dft"].items()}
        if sim.meep_time() < self.minimum_run_time:
            self._prev = cur
            return False
        if sim.meep_time() >= self.maximum_run_time:
            return True
        if self._prev is None:
            self._prev = cur
            return False
        ok = True
        for k, v in cur.items():
            dv = np.abs(v - self._prev[k]).max()
            norm = np.abs(v).max() or 1.0
            if dv > self.tol * norm:
                ok = False
        self._prev = cur
        return ok


# ---------------------------------------------------------------------------
# output step functions (simulation.py:5509 output_* family)
# ---------------------------------------------------------------------------


def output_field(component: str, fname_prefix: str = "field"):
    """Save the component array to an .npy per invocation."""
    counter = {"n": 0}

    def fn(sim, volume=None):
        arr = np.asarray(sim.get_array(component=component))
        np.save(f"{fname_prefix}-{component}-{counter['n']:06d}.npy", arr)
        counter["n"] += 1

    return fn


def output_efield_z(sim, volume=None):
    np.save(f"ez-{int(sim.meep_time() * 1000):08d}.npy",
            np.asarray(sim.get_array(component="ez")))


def output_epsilon(sim, volume=None):
    np.save("epsilon.npy", np.asarray(sim.get_epsilon()))


class FieldProbe:
    """In-scan point time-series sampler: records component `c` at `pt`
    every step at full scan speed (rides the same probe mechanism as
    Harminv; no per-step host sync).  After run(), `.data` holds the
    series and `.dt` the timestep."""

    def __init__(self, c, pt):
        self.c = c
        self.pt = pt
        self.data = np.zeros(0)
        self.dt = None

    def _collect(self, data, dt):
        self.data = np.concatenate([self.data, np.asarray(data)])
        self.dt = dt

    def _analyze(self):
        pass


class WeightedProbe(FieldProbe):
    """In-scan weighted-sum sampler: records sum_i w_i f_c(site_i) every
    step (the per-step surface integral of the Casimir stress-tensor
    method, casimir.cpp stress_chunkloop).  `indices` is an (npts, ndim)
    int array of component-grid indices, `weights` the matching reals."""

    def __init__(self, c, indices, weights):
        super().__init__(c, None)
        self.indices = np.asarray(indices, np.int32)
        self.weights = np.asarray(weights)


def _is_collector(x) -> bool:
    return hasattr(x, "_collect") and hasattr(x, "c") and hasattr(x, "pt")


def parse_step_funcs(step_funcs) -> StepFuncs:
    out = StepFuncs([], [], [], [], [])
    # flatten lists (with_prefix / to_appended / convert_h5 return lists
    # of rewrapped combinators)
    flat = []
    for sf in step_funcs:
        if isinstance(sf, list):
            flat.extend(sf)
        else:
            flat.append(sf)
    step_funcs = flat
    for sf in step_funcs:
        if _is_collector(sf):
            out.collectors.append((sf, False))
        elif isinstance(sf, tuple) and sf:
            tag = sf[0]
            if tag == "after_sources":
                for fn in sf[1]:
                    if _is_collector(fn):
                        out.collectors.append((fn, True))
                    else:
                        out.after_sources_fns.append(fn)
            elif tag == "at_every":
                for fn in sf[2]:
                    out.every.append((sf[1], fn))
            elif tag == "at_beginning":
                out.begin.extend(sf[1])
            elif tag == "at_end":
                out.end.extend(sf[1])
            elif tag == "during_sources":
                for fn in sf[1]:
                    out.every.append((0.0, _only_during_sources(fn)))
        elif callable(sf):
            out.every.append((0.0, sf))
    return out


def _only_during_sources(fn):
    def inner(sim):
        last = max((s.src.last_time() for s in sim.sources), default=0.0)
        if sim.meep_time() <= last:
            fn(sim)
    return inner


# ---------------------------------------------------------------------------
# time-gated combinators (python/simulation.py:5039-5120)
# ---------------------------------------------------------------------------


def at_time(t: float, *fns):
    """Apply fns ONCE, at the first step-func boundary with time >= t."""
    fired = {"done": False}

    def gate(fn):
        def inner(sim, **kw):
            if not fired["done"] and sim.meep_time() >= t - 1e-12:
                fired["done"] = True
                fn(sim, **kw)
        return inner
    # one shared `fired` per at_time call, matching the reference's
    # _when_time closure semantics
    out = []
    for fn in fns:
        g = gate(fn)
        out.append(g)
    return ("at_every", 0.0, tuple(out))


def before_time(t: float, *fns):
    """Apply fns at every boundary while time < t."""
    def gate(fn):
        def inner(sim, **kw):
            if sim.meep_time() < t:
                fn(sim, **kw)
        return inner
    return ("at_every", 0.0, tuple(gate(f) for f in fns))


def after_time(t: float, *fns):
    """Apply fns at every boundary once time >= t."""
    def gate(fn):
        def inner(sim, **kw):
            if sim.meep_time() >= t - 1e-12:
                fn(sim, **kw)
        return inner
    return ("at_every", 0.0, tuple(gate(f) for f in fns))


def after_sources_and_time(t: float, *fns):
    """Apply fns only after sources-off time + t."""
    def gate(fn):
        def inner(sim, **kw):
            last = max((s.src.last_time() for s in sim.sources),
                       default=0.0)
            if sim.meep_time() >= last + t - 1e-12:
                fn(sim, **kw)
        return inner
    return ("at_every", 0.0, tuple(gate(f) for f in fns))


def when_true(cond, *fns):
    """Apply fns at boundaries where cond(sim) is truthy."""
    def gate(fn):
        def inner(sim, **kw):
            if cond(sim):
                fn(sim, **kw)
        return inner
    return ("at_every", 0.0, tuple(gate(f) for f in fns))


def when_false(cond, *fns):
    return when_true(lambda sim: not cond(sim), *fns)


def combine_step_funcs(*fns):
    """One step function applying each plain-callable fn in order."""
    def combined(sim, **kw):
        for fn in fns:
            fn(sim, **kw)
    return combined


def in_point(pt, *fns):
    """Restrict output functions to a single point (in_volume analog)."""
    def wrap(fn):
        def inner(sim):
            return fn(sim, volume=(pt, None))
        return inner
    return ("at_every", 0.0, tuple(wrap(f) for f in fns))


def synchronized_magnetic(*fns):
    """Run fns with H/B served time-synchronized onto E's grid
    (fields::synchronize_magnetic_fields / restore pair): a copy of the
    state is stepped once and H/B averaged; field reads inside fns see
    the synchronized values.  Returns ONE callable step function, so it
    composes inside at_every/at_time like the reference's."""
    def inner(sim, **kw):
        sim._hb_override = sim._synchronized_hb()
        try:
            for fn in fns:
                fn(sim, **kw)
        finally:
            sim._hb_override = None
    return inner


# ---------------------------------------------------------------------------
# stop conditions (simulation.py:5225-5445)
# ---------------------------------------------------------------------------


class stop_after_walltime:
    """Stop once wall-clock seconds since run() start exceed t."""

    def __init__(self, t: float):
        self.t = float(t)
        self._t0 = None

    def check(self, sim) -> bool:
        import time
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0 >= self.t


class stop_on_interrupt:
    """Finish the current block and stop cleanly on SIGINT instead of
    raising KeyboardInterrupt mid-run."""

    def __init__(self):
        self._flag = {"stop": False}
        self._installed = False

    def check(self, sim) -> bool:
        if not self._installed:
            import signal

            def handler(signum, frame):
                self._flag["stop"] = True
            signal.signal(signal.SIGINT, handler)
            self._installed = True
        return self._flag["stop"]


@dataclasses.dataclass
class stop_when_energy_decayed:
    """Stop when the total field energy in the cell decays by decay_by
    from its running peak, checked every dt time units."""
    dt: float = 4.0
    decay_by: float = 1e-3
    _peak: float = 0.0

    def check(self, sim) -> bool:
        cur = float(sim.field_energy_in_box())
        self._peak = max(self._peak, cur)
        return self._peak > 0 and cur <= self.decay_by * self._peak


# ---------------------------------------------------------------------------
# output_* family (simulation.py:5509; components + derived quantities)
# ---------------------------------------------------------------------------


# output redirection context: with_prefix pushes a filename prefix,
# to_appended swaps the per-call file write for an in-memory append
# (written once as a single stacked file at the end of the run), and
# convert_h5 installs a post-write hook (simulation.py:5197-5530 roles)
_output_ctx = {"prefix": "", "append": None, "hook": None}


def _save(sim, tag, arr):
    arr = np.asarray(arr)
    if _output_ctx["append"] is not None:
        _output_ctx["append"].setdefault(tag, []).append(arr)
        return
    pre = _output_ctx["prefix"] + (getattr(sim, "filename_prefix", None)
                                   or "")
    fname = f"{pre}{tag}-{int(round(sim.meep_time() * 1000)):08d}.npy"
    outdir = getattr(sim, "_output_dir", None)
    if outdir:
        import os
        fname = os.path.join(outdir, fname)
    np.save(fname, arr)
    if _output_ctx["hook"] is not None:
        _output_ctx["hook"](fname)


def _map_step_funcs(wrap, step_funcs):
    """Rewrap every plain callable inside tuple combinators (at_every/
    at_beginning/...) and bare callables with `wrap`, preserving the
    combinator structure — the _eval_step_func recursion of the
    reference, applied statically."""
    out = []
    for sf in step_funcs:
        if isinstance(sf, tuple) and sf and isinstance(sf[0], str):
            head, fns = sf[:-1], sf[-1]
            out.append(head + (tuple(wrap(f) for f in fns),))
        elif callable(sf):
            out.append(wrap(sf))
        else:
            out.append(sf)
    return out


def with_prefix(pre, *step_funcs):
    """Prepend `pre` to the file names of any output functions among
    step_funcs (simulation.py:5446)."""
    def wrap(fn):
        def inner(sim, **kw):
            saved = _output_ctx["prefix"]
            _output_ctx["prefix"] = pre + saved
            try:
                fn(sim, **kw)
            finally:
                _output_ctx["prefix"] = saved
        return inner
    return _map_step_funcs(wrap, step_funcs)


def to_appended(fname, *step_funcs):
    """Modify output functions among step_funcs to append their data to
    datasets in a single file named `fname` (plus extension), adding an
    extra leading dimension corresponding to time
    (simulation.py:5197).  Written at the end of the run as HDF5 when
    h5py imports, .npz otherwise."""
    acc: dict = {}

    def wrap(fn):
        def inner(sim, **kw):
            saved = _output_ctx["append"]
            _output_ctx["append"] = acc
            try:
                fn(sim, **kw)
            finally:
                _output_ctx["append"] = saved
        return inner

    def flush(sim, **kw):
        if not acc:
            return
        pre = _output_ctx["prefix"] + (getattr(sim, "filename_prefix",
                                               None) or "")
        data = {tag: np.stack(frames) for tag, frames in acc.items()}
        try:
            import h5py
            path = f"{pre}{fname}.h5"
            with h5py.File(path, "w") as h5:
                for tag, arr in data.items():
                    h5.create_dataset(tag, data=arr)
        except ImportError:
            path = f"{pre}{fname}.npz"
            np.savez(path, **data)
        if _output_ctx["hook"] is not None:
            _output_ctx["hook"](path)
        acc.clear()

    return _map_step_funcs(wrap, step_funcs) + [("at_end", (flush,))]


def convert_h5(rm_h5, convert_cmd, *step_funcs):
    """Run `convert_cmd` (e.g. h5topng flags) on each file written by the
    wrapped output functions, optionally removing the original
    (simulation.py:5509)."""
    import subprocess

    def hook(path):
        cmd = convert_cmd.split() + [path]
        try:
            ret = subprocess.call(cmd)
        except OSError:
            return
        if ret == 0 and rm_h5:
            import os
            os.remove(path)

    def wrap(fn):
        def inner(sim, **kw):
            saved = _output_ctx["hook"]
            _output_ctx["hook"] = hook
            try:
                fn(sim, **kw)
            finally:
                _output_ctx["hook"] = saved
        return inner
    return _map_step_funcs(wrap, step_funcs)


def _output_component(tag, comp):
    def fn(sim, volume=None):
        _save(sim, tag, sim.get_array(component=comp))
    fn.__name__ = f"output_{tag}"
    return fn


def _make_component_outputs():
    g = globals()
    for fam, letter in (("efield", "e"), ("hfield", "h"), ("dfield", "d"),
                        ("bfield", "b")):
        for d in "xyzrp":
            comp = letter + d
            g[f"output_{fam}_{d}"] = _output_component(comp, comp)


_make_component_outputs()


def output_efield(sim, volume=None):
    for c in ("ex", "ey", "ez"):
        try:
            _save(sim, c, sim.get_array(component=c))
        except KeyError:
            pass


def output_hfield(sim, volume=None):
    for c in ("hx", "hy", "hz"):
        try:
            _save(sim, c, sim.get_array(component=c))
        except KeyError:
            pass


def output_dfield(sim, volume=None):
    for c in ("dx", "dy", "dz"):
        try:
            _save(sim, c, sim.get_array(component=c))
        except KeyError:
            pass


def output_bfield(sim, volume=None):
    for c in ("bx", "by", "bz"):
        try:
            _save(sim, c, sim.get_array(component=c))
        except KeyError:
            pass


def _common_crop(arrs):
    """Crop origin-aligned centered arrays to their common shape
    (half-integer Yee axes emit one extra trailing point)."""
    arrs = [a for a in arrs if a is not None]
    if not arrs:
        return []
    shp = tuple(min(a.shape[i] for a in arrs)
                for i in range(arrs[0].ndim))
    return [a[tuple(slice(0, n) for n in shp)] for a in arrs]


def _energy_density(sim, letters):
    """Centered-grid (1/2) sum_c F_c^2 / u_c-ish energy density; for the
    electric side uses E.D/2 with D = eps E via the epsilon grid (exact
    for non-dispersive media, the reference's output_dpwr contract)."""
    total = None
    eps = sim.get_epsilon() if "e" in letters else None
    for c in sim.fields_state["f"]:
        if c[0] not in letters:
            continue
        arr = np.real(np.asarray(sim.get_array(component=c))) ** 2
        if c[0] == "e":
            arr, epsc = _common_crop([arr, np.real(eps)])
            arr = arr * epsc
        if total is None:
            total = arr
        else:
            total, arr = _common_crop([total, arr])
            total = total + arr
    return 0.5 * (total if total is not None else 0.0)


def output_dpwr(sim, volume=None):
    _save(sim, "dpwr", _energy_density(sim, "e"))


def output_hpwr(sim, volume=None):
    _save(sim, "hpwr", _energy_density(sim, "h"))


def output_tot_pwr(sim, volume=None):
    _save(sim, "tot_pwr", _energy_density(sim, "e") +
          _energy_density(sim, "h"))


def _poynting_comp(d):
    cyc = {"x": ("y", "z"), "y": ("z", "x"), "z": ("x", "y"),
           "r": ("p", "z"), "p": ("z", "r")}

    def fn(sim, volume=None):
        p, q = cyc[d]
        hb = sim._synchronized_hb()
        sim._hb_override = hb
        try:
            def get(c):
                try:
                    return np.real(np.asarray(sim.get_array(component=c)))
                except KeyError:
                    return None
            ep_, eq_ = get("e" + p), get("e" + q)
            hp_, hq_ = get("h" + p), get("h" + q)
        finally:
            sim._hb_override = None
        s = 0.0
        if ep_ is not None and hq_ is not None:
            a, b = _common_crop([ep_, hq_])
            s = s + a * b
        if eq_ is not None and hp_ is not None:
            a, b = _common_crop([eq_, hp_])
            sab = a * b
            if np.ndim(s):
                s, sab = _common_crop([s, sab])
            s = s - sab
        _save(sim, f"s{d}", s)
    fn.__name__ = f"output_poynting_{d}"
    return fn


for _d in "xyzrp":
    globals()[f"output_poynting_{_d}"] = _poynting_comp(_d)
    globals()[f"output_sfield_{_d}"] = globals()[f"output_poynting_{_d}"]


def output_poynting(sim, volume=None):
    for d in "xyz":
        try:
            globals()[f"output_poynting_{d}"](sim)
        except KeyError:
            pass


output_sfield = output_poynting


def output_png(component, convert_args: str = "", rm_h5: bool = True):
    """Render the component slice to a PNG per invocation (the
    reference's output_png h5topng pipeline, rendered directly)."""
    counter = {"n": 0}

    def fn(sim, volume=None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        arr = np.real(np.asarray(sim.get_array(component=component)))
        if arr.ndim == 3:
            arr = arr[:, :, arr.shape[2] // 2]
        vmax = np.abs(arr).max() or 1.0
        plt.imsave(f"{component}-{counter['n']:06d}.png", arr.T,
                   cmap="RdBu", vmin=-vmax, vmax=vmax, origin="lower")
        counter["n"] += 1
    return fn


def output_mu(sim, volume=None):
    """Save the permeability grid (identity unless mu materials are
    present)."""
    _save(sim, "mu", sim.get_mu())


def display_progress(t0, t_end, dt):
    """Progress-line step function (the runner already prints a
    step-rate line; this adds the reference's percentage line)."""
    def fn(sim):
        t = sim.meep_time()
        frac = 100.0 * (t - t0) / max(t_end - t0, 1e-30)
        print(f"Meep progress: {t - t0:.1f}/{t_end - t0:.1f} "
              f"= {frac:.1f}% done")
    return ("at_every", dt, (fn,))


def data_to_str(d):
    """Complex-aware datum formatting (simulation.py:5492)."""
    if isinstance(d, complex) or (isinstance(d, np.generic)
                                  and np.iscomplexobj(d)):
        d = complex(d)
        sign = "+" if d.imag >= 0 else ""
        return f"{d.real}{sign}{d.imag}i"
    return str(d)


def display_run_data(sim, data_name, data):
    print(f"{data_name}:, "
          + ", ".join(data_to_str(d) for d in np.atleast_1d(data).tolist()))


def display_csv(sim, name, data):
    """Print each row of `data` as a `name:,`-prefixed CSV line
    (simulation.py:5463)."""
    for d in data:
        display_run_data(sim, name, d)
