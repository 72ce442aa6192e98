"""User-facing Simulation API (analog of python/simulation.py:1216).

Mirrors the reference's constructor surface and run-control while compiling
everything down to the compiled step plan:

    sim = Simulation(cell_size=Vector3(16, 8), resolution=10,
                     geometry=[Block(...)], sources=[Source(...)],
                     boundary_layers=[PML(1.0)])
    flux = sim.add_flux(fcen, df, nfreq, FluxRegion(center=..., size=...))
    sim.run(until=200)
    powers = sim.get_fluxes(flux)
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import grid as G
from ..stepper import monitors as M
from ..stepper.plan import (DftSpec, MaterialSpec, PMLSpec, SrcVolSpec,
                            compile_plan)
from ..stepper import step as S


def _dview(arr) -> "np.ndarray":
    """Host complex view of a real-pair DFT accumulator."""
    return np.asarray(S.dft_view(np.asarray(arr)))
from . import scene
from .geom import Medium, Vector3, _v3, get_center_and_size
from .source import Source, SourceTime

# component constants (python API surface parity)
Ex, Ey, Ez = "ex", "ey", "ez"
Hx, Hy, Hz = "hx", "hy", "hz"
Dx, Dy, Dz = "dx", "dy", "dz"
Bx, By, Bz = "bx", "by", "bz"
Er, Ep, Hr, Hp = "er", "ep", "hr", "hp"
Dr, Dp, Br, Bp = "dr", "dp", "br", "bp"
Dielectric = "eps"
Permeability = "mu"

# derived components (vec.hpp:84 derived_component): Poynting flux and
# energy densities, computed on demand from the stored fields exactly as
# monitor.cpp:71 get_field(derived_component) does
Sx, Sy, Sz, Sr, Sp = "sx", "sy", "sz", "sr", "sp"
EnergyDensity = "energy_density"
D_EnergyDensity = "d_energy_density"
H_EnergyDensity = "h_energy_density"

# S_c = Re{conj(E_a) H_b} - Re{conj(E_b) H_a} with (a, b) the cyclic
# partners of c (monitor.cpp:75-106)
_S_TERMS = {
    "sx": (("ey", "hz"), ("ez", "hy")),
    "sy": (("ez", "hx"), ("ex", "hz")),
    "sz": (("ex", "hy"), ("ey", "hx")),
    "sr": (("ep", "hz"), ("ez", "hp")),
    "sp": (("ez", "hr"), ("er", "hz")),
}
_DERIVED = set(_S_TERMS) | {EnergyDensity, D_EnergyDensity,
                            H_EnergyDensity}

X, Y, Z = "x", "y", "z"
ALL = "all"
R = "r"

# boundary sides / wall conditions (meep.hpp:1606-1609 boundary_side,
# boundary_condition)
Low, High = "low", "high"
Metallic, Magnetic = "metal", "magnetic"


@dataclasses.dataclass
class DiffractedPlanewave:
    """A diffraction-order band specification for
    get_eigenmode_coefficients on a Bloch-periodic monitor
    (python/simulation.py:2477 DiffractedPlanewave; diffractedplanewave
    in src/mpb.cpp): the 'mode' is the analytic planewave of order `g`
    (integer reciprocal-lattice triple), with `s`/`p` complex polarization
    amplitudes defined relative to `axis`."""
    g: Tuple[int, int, int] = (0, 0, 0)
    axis: Any = None              # Vector3; default set per monitor normal
    s: complex = 0.0
    p: complex = 0.0


class Symmetry:
    """Base symmetry declaration (python/simulation.py Symmetry)."""


@dataclasses.dataclass
class Identity(Symmetry):
    """The trivial symmetry (accepted and ignored, as in the
    reference)."""
    direction: str = "x"
    phase: int = 1


@dataclasses.dataclass
class BinaryPartition:
    """Chunk-layout description (python/simulation.py BinaryPartition).

    Accepted for API parity and stored on the Simulation; this framework
    shards the grid UNIFORMLY over the jax device mesh (GSPMD handles
    placement and the XLA latency-hiding scheduler overlaps comms), so a
    user-provided split tree is advisory only — SURVEY.md 2.3 argues the
    cost model away on a mesh of identical devices."""
    data: Any = None
    split_dir: Any = None
    split_pos: Any = None
    left: Any = None
    right: Any = None
    proc_id: Any = None

    def numchunks(self) -> int:
        if self.left is None and self.right is None:
            return 1
        return ((self.left.numchunks() if self.left else 0)
                + (self.right.numchunks() if self.right else 0))


@dataclasses.dataclass
class Mirror(Symmetry):
    """Mirror-symmetry declaration (python/simulation.py Mirror;
    src/symmetry.cpp mirror_symmetry).  The cell is halved along
    `direction`: the symmetry plane through the cell center becomes a PEC
    wall (phase -1: tangential E odd) or a PMC wall (phase +1: tangential
    H odd), which reproduce the odd/even mirror exactly on the Yee mesh.

    Grid alignment: phase -1 needs the plane on a whole grid site
    (size*resolution even along `direction`); phase +1 needs it on a
    half-offset site (size*resolution odd).  Sources given in the dropped
    half are folded onto the retained half with the component's mirror
    parity times `phase`; get_array unfolds full-axis requests."""
    direction: str = "y"
    phase: int = 1


def _mirror_parity(comp: str, d: str) -> float:
    """Intrinsic sign of component `comp` under a mirror in direction `d`
    (vec.hpp:1189 symmetry::transform: E is a vector, H a pseudovector)."""
    if comp[0] in ("e", "d"):
        return -1.0 if comp[1] == d else 1.0
    return 1.0 if comp[1] == d else -1.0


@dataclasses.dataclass
class Rotate2(Symmetry):
    """C2 rotational-symmetry declaration (python/simulation.py Rotate2;
    vec.hpp:1189-1232 symmetry::rotate2).  The cell is halved along the
    first axis perpendicular to `direction` (the rotation axis), with the
    rotation-axis plane landing on a whole grid site (even cell count
    required there).  Unlike Mirror there is no wall: the stepper's
    backward differences across the fold read the C2 ghost
    phase * parity * flip(plane) — under a proper rotation E and H
    transform identically (+ for the component along `direction`,
    - for the two perpendicular ones).

    Sources given entirely in the dropped half fold onto their C2 image
    (both perpendicular coordinates negated) with the transform sign;
    get_array unfolds full requests.  Not supported with chi2/chi3
    nonlinear media, cylindrical/BFAST runs, k_point, or in combination
    with Mirror.  Centered-grid DFT rows exactly ON the fold plane carry
    a half-pixel averaging error (the centered average does not see the
    ghost); keep monitor regions off the plane x=0 when that row
    matters."""
    direction: str = "z"
    phase: int = 1


@dataclasses.dataclass
class Rotate4(Symmetry):
    """C4 rotational-symmetry declaration (python/simulation.py Rotate4;
    vec.hpp:1189-1232 symmetry::rotate4).  The cell is QUARTERED: both
    axes perpendicular to `direction` are halved (square extents and
    even cell counts required), with the rotation axis at their shared
    low corner.  Backward differences across either fold plane read the
    90-degree-rotated ghost: a direct transposed read of the
    x<->y-swapped component at the reflected row (step._rot4_ghost).

    Supported envelope (first landing, like Rotate2's): real fields
    (phase +1/-1 — the +/-i irreps need complex fields), jnp stepper
    path, no k_point / chi2 / chi3 / BFAST / cylindrical / anisotropic
    epsilon, not combined with other symmetries.  Sources along the
    rotation axis (e.g. Ez under C4z) fold from any quadrant; in-plane
    component sources must lie in the retained quadrant.  DFT monitor
    regions must lie in the retained quadrant.  get_array unfolds
    rotation-axis components and epsilon; in-plane components need the
    quadrant's pair partner and are rejected."""
    direction: str = "z"
    phase: int = 1


@dataclasses.dataclass
class PML:
    """uPML boundary layer (python/simulation.py PML class)."""
    thickness: float
    direction: str = ALL
    side: int = 0               # 0 = both, -1 low, +1 high
    r_asymptotic: float = 1e-15
    mean_stretch: float = 1.0
    pml_profile_power: float = 2.0
    pml_profile: Any = None     # arbitrary callable u in [0,1] -> weight
    #                             (python/simulation.py PML pml_profile)

    def __post_init__(self):
        # accept the mp.Low/mp.High ("low"/"high") spellings the python
        # reference API uses and normalize onto the numeric convention
        # every consumer (plan.py:346, _periodic) expects
        if isinstance(self.side, str):
            self.side = {"low": -1, "high": +1, "all": 0, "both": 0}[
                self.side.lower()]


@dataclasses.dataclass
class Absorber(PML):
    """Scalar-conductivity absorber fallback (reference: absorber.cpp via
    meepgeom): a quadratic D+B conductivity ramp instead of uPML, for
    regions where PML fails (e.g. backed by dispersive media); applied by
    _apply_absorbers, validated in test_absorber_timing.py."""


@dataclasses.dataclass
class FluxRegion:
    center: Any = None
    size: Any = None
    direction: Optional[str] = None
    weight: float = 1.0


Near2FarRegion = FluxRegion


@dataclasses.dataclass
class ForceRegion(FluxRegion):
    """Stress-tensor monitor region (python/simulation.py:571): the
    `direction` field is the force direction; the surface normal is
    inferred from the zero-size axis as for FluxRegion."""


@dataclasses.dataclass
class EnergyRegion(FluxRegion):
    """Energy-density monitor region (python/simulation.py:598)."""


@dataclasses.dataclass
class FieldsRegion:
    """add_dft_fields region spec (python/simulation.py:613): either a
    Volume in `where` or an explicit center+size pair."""
    where: Any = None
    center: Any = None
    size: Any = None


def fix_dft_args(args, i):
    """Normalize (fcen, df, nfreq) triples in a positional arg tuple to
    a frequency array (python/simulation.py:72)."""
    if (len(args) > i + 2
            and isinstance(args[i], (int, float))
            and isinstance(args[i + 1], (int, float))
            and isinstance(args[i + 2], int)):
        fcen, df, nfreq = args[i], args[i + 1], args[i + 2]
        freq = ([fcen] if nfreq == 1
                else np.linspace(fcen - 0.5 * df, fcen + 0.5 * df, nfreq))
        return args[:i] + (freq,) + args[i + 3:]
    if not isinstance(args[i], (np.ndarray, list, tuple)):
        raise TypeError("add_dft functions only accept fcen,df,nfreq "
                        "(3 numbers) or freq (array/list)")
    return args


def get_num_args(func):
    """Argument count of a step function or Harminv/PadeDFT-style
    collector (python/simulation.py:96)."""
    import inspect
    from ..analysis.harminv import Harminv as _Hv
    from ..analysis.pade import PadeDFT as _Pd
    if isinstance(func, (_Hv, _Pd)):
        return 2
    if inspect.ismethod(func):
        return func.__code__.co_argcount - 1
    return func.__code__.co_argcount


def vec(*args):
    """Vector3 constructor accepting vec(x[,y[,z]]) or vec(iterable)
    (python/simulation.py:105; the SWIG mp._vec role)."""
    if len(args) == 1 and not isinstance(args[0], (int, float)):
        args = tuple(args[0])
    return Vector3(*args)


def py_v3_to_vec(dims: int, iterable, is_cylindrical: bool = False):
    """Project a Vector3-like onto the grid's live coordinates
    (python/simulation.py:122): 1d keeps z, cylindrical keeps (r, z)."""
    v = Vector3(*tuple(iterable))
    if dims == 1:
        return (v.z,)
    if dims == 2:
        if is_cylindrical:
            return (v.x, v.z)
        return (v.x, v.y, v.z)   # z retained for special_kz handling
    if dims == 3:
        return (v.x, v.y, v.z)
    raise ValueError(f"Invalid dimensions in Volume: {dims}")


@dataclasses.dataclass
class _N2FHandle:
    name: str
    freqs: np.ndarray
    surfaces: list
    eps: float = 1.0          # ambient medium at the near surface
    mu: float = 1.0
    m: float = 0.0            # cylindrical azimuthal number
    periodic: tuple = ()      # (axis, nper, phase_per_period, period)
    mirrors: tuple = ()       # (axis, d_letter, phase) fold image terms


@dataclasses.dataclass
class _FluxHandle:
    name: str
    freqs: np.ndarray


@dataclasses.dataclass
class _DftFieldsHandle:
    name: str
    components: List[str]
    freqs: np.ndarray


def _vec_to_axes(gv: G.GridVolume, v) -> List[float]:
    """Map a Vector3-like to grid-axis coordinates."""
    v = _v3(v if v is not None else Vector3())
    slot = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}
    out = []
    for d in gv.axes:
        out.append(tuple(v)[slot[d]])
    if gv.dim == "1d":
        out = [v.z]
    return out


class Simulation:
    """The top-level scene + run controller (simulation.py:1216)."""

    def __init__(self,
                 cell_size,
                 resolution: float,
                 geometry: Sequence = (),
                 sources: Sequence[Source] = (),
                 boundary_layers: Sequence[PML] = (),
                 default_material: Medium = None,
                 dimensions: Optional[int] = None,
                 k_point=None,
                 Courant: float = 0.5,
                 force_complex_fields: bool = False,
                 eps_averaging: bool = True,
                 subpixel_n: int = 3,
                 subpixel_tensor: bool = False,
                 force_all_components: bool = False,
                 m: float = 0,
                 bfast_scaled_k=None,
                 slab_store: bool = False,
                 epsilon_input_file: str = None,
                 filename_prefix: str = None,
                 symmetries: Sequence = (),
                 kz_2d: str = "complex",
                 material_function=None,
                 epsilon_func=None,
                 chunk_layout=None,
                 geometry_center=None,
                 extra_materials=(),
                 dtype=np.float32):
        self.cell_size = _v3(cell_size)
        self.resolution = float(resolution)
        self.geometry = list(geometry)
        # chunk_layout (BinaryPartition / int) is advisory: the grid is
        # sharded uniformly over the jax device mesh (GSPMD)
        self.chunk_layout = chunk_layout
        self.extra_materials = list(extra_materials)
        if geometry_center is not None:
            gc = _v3(geometry_center)
            if any(abs(v) > 1e-300 for v in gc):
                import dataclasses as _dc
                self.geometry = [
                    _dc.replace(g, center=Vector3(*(np.asarray(list(_v3(
                        g.center))) + np.asarray(list(gc)))))
                    if hasattr(g, "center") else g for g in self.geometry]
        self.sources = list(sources)
        self.boundary_layers = list(boundary_layers)
        self.default_material = default_material or Medium()
        self.k_point = k_point
        self.courant = Courant
        self.force_complex_fields = force_complex_fields
        self.eps_averaging = eps_averaging
        self.subpixel_n = subpixel_n
        self.subpixel_tensor = subpixel_tensor
        self.force_all_components = force_all_components
        self.m = m
        self.bfast_scaled_k = bfast_scaled_k
        self.slab_store = slab_store
        self.epsilon_input_file = epsilon_input_file
        self.filename_prefix = filename_prefix
        self._output_dir = None
        self._eps_override = None        # set_epsilon() array override
        # 2D + k_point.z != 0 (the reference's special_kz): fields carry
        # an exact e^{i kz z} dependence; accepted values mirror meep's
        # kz_2d — this implementation always integrates the complex (or
        # real-pair) fields, which is meep's "complex" mode ("real/imag"
        # is its memory-layout trick for the same physics)
        if kz_2d not in ("complex", "real/imag", "3d"):
            raise ValueError(f"kz_2d: unknown mode {kz_2d!r}")
        self.kz_2d = kz_2d
        # user-defined materials (python/tests/test_user_defined_material
        # semantics): material_function(Vector3) -> Medium, or
        # epsilon_func(Vector3) -> scalar eps; applied wherever geometry
        # objects leave the default material.  Geometry objects whose
        # `material` is itself callable are treated as per-object
        # epsilon functions.
        self.material_function = material_function
        self.epsilon_func = epsilon_func
        self.dtype = dtype

        # infer dimensionality (meep: z-only -> 1d; z==0 -> 2d)
        cs = self.cell_size
        if dimensions == 1 or (cs.x == 0 and cs.y == 0 and cs.z > 0):
            self.dim = "1d"
            size = [cs.z]
        elif dimensions in (None, 2) and cs.z == 0 and cs.x > 0 and cs.y > 0:
            self.dim = "2d"
            size = [cs.x, cs.y]
        elif dimensions == -2 or dimensions == "cyl" or dimensions == "CYLINDRICAL":
            self.dim = "cyl"
            size = [cs.x, cs.z]
        else:
            self.dim = "3d"
            size = [cs.x, cs.y, cs.z]

        # (dir_letter, side) -> 'metal'|'magnetic'; filled by symmetries
        # below and by set_boundary()
        self._boundaries = {}

        # mirror symmetries: halve the cell, put the right wall at the plane
        self.symmetries = list(symmetries)
        self._mirrors = []          # (axis_index, direction_letter, phase)
        self._mirror_node = set()   # axes whose mirror plane is ON a node
        self._rot2 = None           # (fold_ax, flip_ax, w_letter, phase)
        self._rot4 = None           # (ax1, ax2, w_letter, phase)
        origin = None
        if self.symmetries:
            def _absorbing_both_sides(dletter):
                lo = hi = False
                for bl in self.boundary_layers:
                    dirs_ = (("x", "y", "z", "r")
                             if bl.direction == ALL else (bl.direction,))
                    if dletter in dirs_:
                        if bl.side in (0, -1):
                            lo = True
                        if bl.side in (0, +1):
                            hi = True
                return lo and hi

            def _k_along(dletter):
                if k_point is None:
                    return 0.0
                kp_ = _v3(k_point)
                return {"x": kp_.x, "y": kp_.y, "z": kp_.z,
                        "r": kp_.x, "p": 0.0}.get(dletter, 0.0)

            axes = G._DIM_AXES[self.dim]
            dx = 1.0 / self.resolution
            origin = [0.0 if (self.dim == "cyl" and d == "r")
                      else -s / 2 for d, s in zip(axes, size)]
            for sym in self.symmetries:
                if isinstance(sym, (Rotate2, Rotate4)) and \
                        k_point is not None:
                    raise ValueError(
                        "rotational symmetries with k_point are not "
                        "supported (the rotation maps k onto its image; "
                        "only k=0 is invariant)")
                if isinstance(sym, Rotate4):
                    if self.dim not in ("2d", "3d"):
                        raise NotImplementedError(
                            "Rotate4 needs a 2d/3d cartesian cell")
                    w = sym.direction
                    if int(sym.phase) not in (1, -1):
                        raise NotImplementedError(
                            "Rotate4 phase must be +1/-1 (the +/-i "
                            "irreps need complex fields)")
                    perp = [dd for dd in ("x", "y", "z") if dd != w]
                    if any(dd not in axes for dd in perp):
                        raise ValueError(
                            f"Rotate4({w}) needs both perpendicular axes "
                            "as grid axes")
                    if self._mirrors or self._rot2 is not None \
                            or self._rot4 is not None:
                        raise NotImplementedError(
                            "Rotate4 combined with other symmetries is "
                            "not supported")
                    a1, a2 = (axes.index(perp[0]), axes.index(perp[1]))
                    if abs(size[a1] - size[a2]) > 1e-12:
                        raise ValueError(
                            f"Rotate4({w}) needs a square cell in the "
                            f"{perp[0]}{perp[1]} plane")
                    for ax_ in (a1, a2):
                        n_full = int(round(size[ax_] * self.resolution))
                        if n_full % 2:
                            raise ValueError(
                                f"Rotate4({w}) needs even cell counts "
                                f"along {axes[ax_]} (have {n_full}) so "
                                "the rotation axis lands on a whole "
                                "grid site")
                        size[ax_] = size[ax_] / 2
                        origin[ax_] = 0.0
                        self._boundaries[(axes[ax_], "low")] = "none"
                    self._rot4 = (a1, a2, w, int(sym.phase))
                    continue
                if isinstance(sym, Rotate2):
                    if self.dim not in ("2d", "3d"):
                        raise NotImplementedError(
                            "Rotate2 needs a 2d/3d cartesian cell")
                    w = sym.direction
                    perp = [dd for dd in ("x", "y", "z") if dd != w]
                    fold_d, flip_d = perp
                    if fold_d not in axes or flip_d not in axes:
                        raise ValueError(
                            f"Rotate2({w}) needs both {fold_d} and "
                            f"{flip_d} as grid axes")
                    if self._mirrors or self._rot2 is not None \
                            or self._rot4 is not None:
                        raise NotImplementedError(
                            "Rotate2 combined with other symmetries is "
                            "not supported")
                    fax = axes.index(fold_d)
                    n_full = int(round(size[fax] * self.resolution))
                    if n_full % 2:
                        raise ValueError(
                            f"Rotate2({w}) needs an even cell count along "
                            f"{fold_d} (have {n_full}) so the rotation "
                            "axis lands on a whole grid site")
                    size[fax] = size[fax] / 2
                    origin[fax] = 0.0
                    self._boundaries[(fold_d, "low")] = "none"
                    self._rot2 = (fax, axes.index(flip_d), w,
                                  int(sym.phase))
                    continue
                if isinstance(sym, Identity):
                    continue
                if not isinstance(sym, Mirror):
                    raise NotImplementedError(
                        "only Mirror/Rotate2/Rotate4 symmetries are "
                        "supported")
                if self._rot2 is not None or self._rot4 is not None:
                    raise NotImplementedError(
                        "rotational symmetries combined with Mirror are "
                        "not supported")
                d = sym.direction
                if d not in axes:
                    raise ValueError(f"no grid axis {d} in {self.dim}")
                if k_point is not None and (
                        _k_along(d) != 0.0 or not _absorbing_both_sides(d)):
                    # a mirror commutes with the Bloch phase only when k
                    # has no component along the mirror normal AND the
                    # folded axis is not itself Bloch-wrapped (the fold
                    # wall replaces the wrap; absorbing layers both sides
                    # make the wrap inert — see _periodic); matches the
                    # reference's symmetry/k compatibility
                    # (structure.cpp via symmetry.cpp transforms)
                    raise ValueError(
                        f"Mirror({d}) with k_point requires k.{d} == 0 "
                        f"and absorbing layers on both {d} sides")
                ax = axes.index(d)
                n_full = int(round(size[ax] * self.resolution))
                if sym.phase == -1:
                    if n_full % 2:
                        raise ValueError(
                            f"Mirror({d}, phase=-1) needs an even cell "
                            f"count along {d} (have {n_full}) so the "
                            "symmetry plane lands on a whole grid site")
                    size[ax] = size[ax] / 2
                    origin[ax] = 0.0
                    self._boundaries[(d, "low")] = "metal"
                elif n_full % 2 == 0:
                    # phase=+1 on an even count: the plane lands ON a
                    # whole grid site.  No wall expresses an even mirror
                    # at a node; the stepper reads a mirror ghost across
                    # the plane instead (plan.mirror_node, matching the
                    # reference's symmetry-transformed ghost points,
                    # boundaries.cpp loop over symmetry images)
                    size[ax] = size[ax] / 2
                    origin[ax] = 0.0
                    self._boundaries[(d, "low")] = "none"
                    self._mirror_node.add(ax)
                else:
                    size[ax] = size[ax] / 2 + dx / 2
                    origin[ax] = -dx / 2
                    self._boundaries[(d, "low")] = "magnetic"
                self._mirrors.append((ax, d, int(sym.phase)))
        self.gv = G.GridVolume.create(self.dim, size, self.resolution,
                                      origin=origin)

        self._dft_specs: List[DftSpec] = []
        self._handles: List[Any] = []
        self._plan = None
        self._state = None
        self._t = 0   # host-side step counter (no device read per block)
        self._last_progress = None
        from ..utils.timing import Timers
        self.timers = Timers()

    def set_boundary(self, side, direction, condition):
        """Set the wall condition on one cell face (meep.hpp:1776
        set_boundary; boundary_condition enum at :1609).  `side` is mp.Low /
        mp.High (or 'low'/'high'), `direction` mp.X/Y/Z/R (or a letter),
        `condition` mp.Metallic or mp.Magnetic.  Must be called before the
        fields are initialized."""
        if self._plan is not None:
            raise RuntimeError("set_boundary must precede init_sim()")
        sd = side if isinstance(side, str) else ("low" if side < 0 else "high")
        sd = sd.lower()
        d = direction if isinstance(direction, str) else "xyzrp"[direction]
        cond = condition if isinstance(condition, str) else \
            ("metal" if condition == 0 else "magnetic")
        cond = {"metallic": "metal"}.get(cond.lower(), cond.lower())
        if cond not in ("metal", "magnetic", "none"):
            raise ValueError(f"unknown boundary condition {condition}")
        self._boundaries[(d, sd)] = cond

    # ------------------------------------------------------------------ setup
    @property
    def dt(self) -> float:
        return self.courant / self.resolution

    def _periodic(self) -> Tuple[bool, ...]:
        """Bloch-periodic axes for a given k_point.

        The reference connects chunk boundaries with the Bloch phase in
        EVERY direction when a k_point is set (boundaries.cpp:88
        use_bloch) — including directions whose boundaries sit behind
        double-sided PML, where the wrapped values are attenuated to the
        PML reflection floor and the connection is physically inert.  We
        drop the wrap on axes whose k component is zero AND whose both
        ends carry an absorbing layer: the zero-fill (metal-backed PML)
        boundary there is equivalent below the PML floor, and the stepper
        then skips the wrapped shifts on that axis."""
        if self.k_point is None:
            return (False,) * self.gv.ndim
        kv = _vec_to_axes(self.gv, _v3(self.k_point))
        lo_cov = [False] * self.gv.ndim
        hi_cov = [False] * self.gv.ndim
        for bl in self.boundary_layers:
            dirs = list(self.gv.axes) if bl.direction == ALL \
                else [bl.direction]
            for d in dirs:
                ax = self.gv.axes.index(d) if d in self.gv.axes else None
                if ax is None:
                    continue
                if bl.side in (0, -1):
                    lo_cov[ax] = True
                if bl.side in (0, +1):
                    hi_cov[ax] = True
        return tuple(not (kv[ax] == 0.0 and lo_cov[ax] and hi_cov[ax])
                     for ax in range(self.gv.ndim))

    def _live_components(self) -> Tuple[List[str], List[str]]:
        """Component closure from sources+monitors (fields::require_component)."""
        if self.force_all_components or (
                self.dim == "2d" and self.k_point is not None
                and _v3(self.k_point).z != 0.0):
            # special_kz: the i*beta coupling mixes TE and TM — every
            # component is live
            return list(self.gv.e_components), list(self.gv.h_components)
        need = set()
        for s in self.sources:
            if getattr(s, "component", None) is None:
                # exact Gaussian beam: drives all four tangential sheets
                need |= set(self.gv.e_components) | set(self.gv.h_components)
            else:
                need.add(s.component)
        need |= {s.component for s in getattr(self, "_extra_srcs", [])}
        need |= {m.component for m in self._dft_specs}
        # gyrotropic media precess P about the bias axis, coupling every
        # component of the susceptibility's field type
        # (susceptibility.cpp:519); pull the partners in if any driven
        # component carries such a pole
        all_media = [getattr(g, "material", None) for g in self.geometry]
        all_media.append(self.default_material)
        all_media += list(self.extra_materials)
        for med in all_media:
            if med is None or not hasattr(med, "E_susceptibilities"):
                continue
            for ft, sus_list in (("e", med.E_susceptibilities),
                                 ("h", med.H_susceptibilities)):
                if any(getattr(s_, "bias", None) is not None and
                       np.linalg.norm(list(_v3(s_.bias))) > 0
                       for s_ in sus_list
                       if hasattr(s_, "bias")):
                    comps = self.gv.e_components if ft == "e" \
                        else self.gv.h_components
                    if need & set(comps) or not need:
                        need |= set(comps)
        live = set(need)
        changed = True
        while changed:
            changed = False
            for c in list(live):
                if c[0] not in "eh":
                    continue
                dbc = ("d" if c[0] == "e" else "b") + c[1]
                plan = self.gv.step_plan(dbc)
                for g in (plan.plus, plan.minus):
                    if g is not None and g not in live:
                        live.add(g)
                        changed = True
        live_e = [c for c in self.gv.e_components if c in live]
        live_h = [c for c in self.gv.h_components if c in live]
        if not live_e and not live_h:
            live_e = list(self.gv.e_components)
            live_h = list(self.gv.h_components)
        return live_e, live_h

    def _fold_source(self, s):
        """Reflect a source lying in the dropped half of a mirrored cell
        onto the retained half, scaled by phase * component mirror parity
        (the symmetry projection of fields::add_volume_source under
        symmetry.cpp transforms)."""
        import dataclasses as dc
        if self._rot4 is not None and hasattr(s, "center"):
            a1, a2, w, phase = self._rot4
            axes = self.gv.axes
            c = list(_v3(s.center))
            sz = list(_v3(s.size)) if getattr(s, "size", None) is not None \
                else [0.0, 0.0, 0.0]
            slot3 = {"x": 0, "y": 1, "z": 2}
            i, j = slot3[axes[a1]], slot3[axes[a2]]
            lo_i, hi_i = c[i] - 0.5 * sz[i], c[i] + 0.5 * sz[i]
            lo_j, hi_j = c[j] - 0.5 * sz[j], c[j] + 0.5 * sz[j]
            if lo_i >= -1e-12 and lo_j >= -1e-12:
                return s                   # already in the wedge
            if (lo_i < -1e-12 and hi_i > 1e-12) or \
                    (lo_j < -1e-12 and hi_j > 1e-12):
                raise ValueError(
                    "source straddles a Rotate4 fold plane; place it in "
                    "one quadrant")
            if s.component[1] != w:
                raise ValueError(
                    f"in-plane-component source ({s.component}) outside "
                    "the retained Rotate4 quadrant: its fold swaps the "
                    "component — place it in the retained quadrant")
            # rotate the center into the wedge by k quarter turns; the
            # w-component picks up phase^k (F_w(R r) = phase * F_w(r))
            amp = s.amplitude
            for _k in range(3):
                if c[i] >= -1e-12 and c[j] >= -1e-12:
                    break
                c[i], c[j] = c[j], -c[i]       # R^-1: (x, y) -> (y, -x)
                sz[i], sz[j] = sz[j], sz[i]
                amp = amp * phase
            s = dc.replace(s, center=Vector3(*c), size=Vector3(*sz),
                           amplitude=amp)
            return s
        if self._rot2 is not None and hasattr(s, "center"):
            fax, lax_, _w, phase = self._rot2
            axes = self.gv.axes
            c = list(_v3(s.center))
            sz = list(_v3(s.size)) if getattr(s, "size", None) is not None \
                else [0.0, 0.0, 0.0]
            slot3 = {"x": 0, "y": 1, "z": 2}
            i = slot3[axes[fax]]
            j = slot3[axes[lax_]]
            if c[i] - 0.5 * sz[i] < -1e-12 and c[i] + 0.5 * sz[i] > 1e-12:
                # straddles the fold plane: only a C2-centered source can
                # be represented by clipping (its dropped part's image IS
                # the retained part)
                if abs(c[i]) > 1e-12 or abs(c[j]) > 1e-12:
                    raise ValueError(
                        "source straddles the Rotate2 fold plane; center "
                        "it on the rotation axis or place it in one half")
                return s
            if c[i] < -1e-12:
                c[i], c[j] = -c[i], -c[j]
                sign = phase \
                    * _mirror_parity(s.component, axes[fax]) \
                    * _mirror_parity(s.component, axes[lax_])
                s = dc.replace(s, center=Vector3(*c),
                               amplitude=s.amplitude * sign)
            return s
        if not self._mirrors or not hasattr(s, "center"):
            return s
        slot = {"x": 0, "y": 1, "z": 2}
        for ax, d, phase in self._mirrors:
            c = list(_v3(s.center))
            i = slot[d] if self.dim != "1d" else 2
            sz = list(_v3(s.size)) if getattr(s, "size", None) is not None \
                else [0.0, 0.0, 0.0]
            # straddle check applies on BOTH sides of the plane: a source
            # centered in the retained half whose extent crosses the plane
            # would be silently clipped by the grid otherwise
            if abs(c[i]) > 1e-12 and sz[i] > 2 * abs(c[i]) + 1e-12:
                raise ValueError(
                    f"source straddles the {d} mirror plane "
                    "asymmetrically; place it in the retained half "
                    "(or symmetrically about the plane)")
            if c[i] < -1e-12:
                c[i] = -c[i]
                sign = phase * _mirror_parity(s.component, d)
                s = dc.replace(s, center=Vector3(*c),
                               amplitude=s.amplitude * sign)
        return s

    def _mirror_fix_dft_specs(self, specs):
        """Half-offset-aligned mirrors put the first CENTERED tangential
        row ON the plane; its Yee->center average along that axis saw the
        zero ghost layer below the wall, so the stored value is half the
        full cell's for even components (and spurious for odd ones).
        Restore with the component parity: weight x(1+s) — even comps get
        the image's half back, odd comps' full-cell centered row is
        identically zero.  Applied only to axes _fold_region folded
        symmetrically (a region that genuinely starts at the plane keeps
        the one-sided average, same as the full cell)."""
        axes_sym = getattr(self, "_fold_sym_axes", set())
        for spec in specs:
            if not getattr(spec, "centered", True):
                continue
            for ax, d, phase in self._mirrors:
                node = (phase == -1) or (ax in self._mirror_node)
                if node or ax not in axes_sym:
                    continue
                if spec.region[ax][0] != 0:
                    continue
                s = phase * _mirror_parity(spec.component, d)
                w = np.array(spec.weights, dtype=float)
                sl = [slice(None)] * w.ndim
                sl[ax] = slice(0, 1)
                w[tuple(sl)] *= (1.0 + s)
                spec.weights = w
        return specs

    def _fold_region(self, center, size, parity_fn):
        """Fold a DFT monitor region on a mirrored cell onto the retained
        half, returning (center, size, factor).  Also records which axes
        were folded symmetrically in self._fold_sym_axes (consumed by
        _mirror_fix_dft_specs).

        `parity_fn(d)` is the parity of the monitored *product* quantity
        under the mirror in direction `d` (cf. symmetry-aware
        loop_in_chunks in the reference, src/loop_in_chunks.cpp): a region
        symmetric about the plane is clipped to the retained half with its
        dropped-half contribution absorbed into `factor = 1 + parity`; a
        region entirely in the dropped half maps to its image with
        `factor = parity`.  Asymmetric straddles raise — they cannot be
        represented on the half-grid."""
        center = list(center)
        size = list(size)
        factor = 1.0
        self._fold_sym_axes = set()
        if self._rot4 is not None:
            a1, a2, _w, _phase = self._rot4
            for ax_ in (a1, a2):
                if center[ax_] - 0.5 * size[ax_] < -1e-9:
                    raise ValueError(
                        "DFT region extends outside the retained Rotate4 "
                        "quadrant; place monitors in the quadrant (their "
                        "images are rotated surfaces with swapped "
                        "components, not representable by a weight)")
            return center, size, factor
        if self._rot2 is not None:
            fax, lax_, _w, phase = self._rot2
            axes = self.gv.axes
            par = phase * parity_fn(axes[fax]) * parity_fn(axes[lax_])
            i, j = fax, lax_
            lo = center[i] - 0.5 * size[i]
            hi = center[i] + 0.5 * size[i]
            if lo >= -1e-9:
                return center, size, factor
            if hi <= 1e-9:                    # entirely in the dropped half
                center[i] = -center[i]
                center[j] = -center[j]
                return center, size, factor * par
            if abs(center[i]) < 1e-9 and abs(center[j]) < 1e-9:
                # C2-centered: clip to the retained half; the dropped
                # part's image is the retained footprint.  The fold plane
                # lies midway between centered-lattice columns, so a clip
                # at exactly 0 would strand the sub-pixel boundary weight
                # on the dropped first column (loop_in_chunks.cpp:30-100
                # w0^2/2 sliver): extend the edge to just inside -dx/2 so
                # the first retained column keeps its interior weight —
                # the dropped sliver is then exactly the image half the
                # (1 + par) factor accounts for.
                dx = self.gv.dx
                lo2 = -0.5 * dx * (1.0 - 1e-6)
                center[i] = 0.5 * (lo2 + hi)
                size[i] = hi - lo2
                return center, size, factor * (1.0 + par)
            raise ValueError(
                "DFT region straddles the Rotate2 fold plane "
                "asymmetrically; center it on the rotation axis or place "
                "it in one half of the cell")
        for ax, d, phase in self._mirrors:
            if d not in self.gv.axes:
                continue
            i = self.gv.axes.index(d)
            lo = center[i] - 0.5 * size[i]
            hi = center[i] + 0.5 * size[i]
            if lo >= -1e-9:
                continue                      # retained half: unchanged
            par = parity_fn(d)
            if hi <= 1e-9:                    # entirely in the dropped half
                center[i] = -center[i]
                factor *= par
            elif abs(center[i]) < 1e-9:       # symmetric about the plane
                lo2 = 0.0
                if phase == -1 or ax in self._mirror_node:
                    # whole-site plane alignment: the plane is midway
                    # between centered columns — extend the edge to just
                    # inside -dx/2 so the first retained column keeps its
                    # interior weight (see the Rotate2 branch above)
                    lo2 = -0.5 * self.gv.dx * (1.0 - 1e-6)
                else:
                    # half-offset alignment: the plane IS centered row 0;
                    # lo2=0 gives it the edge-on-site half weight and
                    # _mirror_fix_dft_specs restores the image's share
                    # with the component parity (x(1+s))
                    self._fold_sym_axes.add(ax)
                center[i] = 0.5 * (lo2 + hi)
                size[i] = hi - lo2
                factor *= (1.0 + par)
            else:
                raise ValueError(
                    f"DFT region straddles the {d} mirror plane "
                    "asymmetrically; use a symmetric region or place it "
                    "in one half of the cell")
        return center, size, factor

    def _expand_gaussian_beam(self, s) -> List:
        """Exact Gaussian beam -> 4 equivalence-current sheet sources
        K = n x H, N = -n x E with the complex-source-point beam fields
        (fields::add_volume_source(gaussianbeam), sources.cpp:526-556)."""
        from .source import Source as _Src, gaussian_beam_fields
        f = s.frequency or getattr(s.src, "frequency", None)
        if f is None:
            raise ValueError("GaussianBeamSource needs a frequency")
        sz = _v3(s.size if s.size is not None else Vector3())
        live_dirs = [{"x": 0, "y": 1, "z": 2}[d] for d in self.gv.axes
                     if d in "xyz"]
        normal = next(i for i in live_dirs if sz[i] == 0)
        def vec3(v, dtype=float):
            v3 = _v3(v)
            return np.array([v3.x, v3.y, v3.z], dtype)

        x0 = vec3(s.beam_x0)                       # relative to center
        kdir = vec3(s.beam_kdir)
        if np.isscalar(s.beam_E0):
            raise ValueError("exact GaussianBeamSource needs a "
                             "polarization 3-vector beam_E0")
        E0 = vec3(s.beam_E0, complex)

        def beam_amp(row):
            def amp(p):                  # p relative to the source center
                pt = np.array([p.x, p.y, p.z], float) - x0
                EH = gaussian_beam_fields(pt[None, :], np.zeros(3), kdir,
                                          s.beam_w0, f, E0)
                return complex(EH[row, 0])
            return amp

        np1, np2 = (normal + 1) % 3, (normal + 2) % 3
        cE = ["ex", "ey", "ez"]
        cH = ["hx", "hy", "hz"]
        import dataclasses as dc
        out = []
        for comp, row, sgn in ((cE[np2], 3 + np1, +1.0),
                               (cE[np1], 3 + np2, -1.0),
                               (cH[np2], np1, -1.0),
                               (cH[np1], np2, +1.0)):
            out.append(_Src(src=s.src, component=comp, center=s.center,
                            size=s.size, amplitude=s.amplitude * sgn,
                            amp_func=beam_amp(row)))
        return out

    def _build_sources(self, live_e, live_h) -> List[SrcVolSpec]:
        from .source import IndexedSource, GaussianBeamSource
        out = []
        gv = self.gv
        sources = []
        for s in self.sources:
            if isinstance(s, GaussianBeamSource) and s.component is None:
                sources += self._expand_gaussian_beam(s)
            else:
                sources.append(s)
        for s in sources:
            if (self._mirrors or self._rot2 is not None
                    or self._rot4 is not None) \
                    and not isinstance(s, IndexedSource):
                s = self._fold_source(s)
            comp = s.component
            if isinstance(s, IndexedSource):
                out.append(SrcVolSpec(
                    comp, np.asarray(s.indices, np.int32),
                    np.asarray(s.amplitudes, np.complex128), s.src))
                continue
            center = _vec_to_axes(gv, s.center)
            size = _vec_to_axes(gv, s.size) if s.size is not None else \
                [0.0] * gv.ndim
            mirror_axes = {axq for axq, _, _ in self._mirrors}
            if all(sz == 0 for sz in size):
                pts = gv.interp_weights(comp, center)
                if mirror_axes:
                    # a source near the mirror plane may interpolate onto
                    # the below-plane ghost row (half-offset alignment
                    # keeps one at -dx/2): that weight belongs to the
                    # image row the symmetry already supplies — drop it
                    pts = [(p, w) for p, w in pts if all(
                        gv.comp_coords(comp, axq)[p[axq]] > -1e-9
                        for axq in mirror_axes)]
                idx = np.array([p for p, w in pts], np.int32)
                amps = np.array([w * s.amplitude for p, w in pts],
                                np.complex128)
                # restriction weight: delta-normalized current
                amps *= self.resolution ** gv.ndim
            else:
                # volume source: all component sites inside, weighted by the
                # same integration scheme as monitors; amplitude-function
                # support via s.amp_func
                idx_list, amp_list = [], []
                amp_func = s.amp_func
                if amp_func is None and getattr(s, "amp_data", None) \
                        is not None:
                    from .source import amp_data_func
                    amp_func = amp_data_func(s.amp_data, size)
                slices, w_arr = _volume_sites(gv, comp, center, size)
                it = np.ndindex(*w_arr.shape)
                base = [sl.start for sl in slices]
                for ind in it:
                    w = w_arr[ind]
                    if w == 0:
                        continue
                    gidx = tuple(b + i for b, i in zip(base, ind))
                    if mirror_axes:
                        drop = False
                        for axq in mirror_axes:
                            cv = gv.comp_coords(comp, axq)[gidx[axq]]
                            if cv < -1e-9:
                                drop = True        # ghost-row spill
                            elif cv <= 1e-9 and \
                                    center[axq] - size[axq] / 2 < -1e-9:
                                # plane row of a region extending below
                                # the plane: the grid clip gave it the
                                # EDGE weight; the full-cell row is
                                # interior — restore its other half
                                w = w * 2.0
                        if drop:
                            continue
                    amp = s.amplitude * w
                    if amp_func is not None:
                        # meep convention: amp_func receives the point
                        # RELATIVE to the source center (python/source.py)
                        pt = _site_coord(gv, comp, gidx)
                        c3 = _v3(s.center)
                        rel = Vector3(pt.x - c3[0], pt.y - c3[1],
                                      pt.z - c3[2])
                        amp = amp * amp_func(rel)
                    idx_list.append(gidx)
                    amp_list.append(amp)
                idx = np.array(idx_list, np.int32).reshape(-1, gv.ndim)
                amps = np.array(amp_list, np.complex128)
                # normalize per transverse delta dims
                ndelta = sum(1 for sz in size if sz == 0)
                amps *= self.resolution ** ndelta
            out.append(SrcVolSpec(comp, idx, amps, s.src,
                                  is_integrated=getattr(s.src, "is_integrated",
                                                        False)))
        return out

    def _apply_material_function(self, mat, geometry, fn_objs, live_e):
        """User-defined materials (the reference's material_function /
        epsilon_func, python/tests/test_user_defined_material.py):
        sample the function pointwise at every E site governed by the
        default material (simulation-level function) or by a
        function-material object (`fn_objs`: geometry index -> callable).
        The function receives the absolute position as a Vector3 and
        returns a Medium (material_function) or a scalar epsilon
        (epsilon_func).  Pointwise, no subpixel averaging — matching the
        reference's default for material functions."""
        from .scene import _material_at, _site_points
        dind_of = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}

        def eval_fn(fn, pts_flat, dind, as_medium):
            out = np.empty(len(pts_flat))
            cond = np.zeros(len(pts_flat))
            for k, p in enumerate(pts_flat):
                v = Vector3(float(p[0]), float(p[1]), float(p[2]))
                if as_medium:
                    m = fn(v)
                    out[k] = tuple(m.eps_diag_vec())[dind]
                    cond[k] = float(m.D_conductivity)
                else:
                    out[k] = float(fn(v))
            return out, cond

        sim_fn = self.material_function or self.epsilon_func
        sim_is_medium = self.material_function is not None
        for c in live_e:
            d_c = G.component_direction(c)
            dind = dind_of[d_c]
            pts = _site_points(self.gv, c)
            idx = _material_at(pts, geometry, self.default_material)
            row = mat.chi1inv.setdefault(c, {}).get(d_c)
            base = np.ones(self.gv.shape) if row is None \
                else np.array(row, np.float64)
            crow = mat.cond.get("d" + c[1])
            cbase = None
            targets = []
            if sim_fn is not None:
                targets.append((idx == -1, sim_fn, sim_is_medium))
            for i, fn in fn_objs.items():
                targets.append((idx == i, fn,
                                isinstance(fn(Vector3(0, 0, 0)), Medium)))
            for sel, fn, as_medium in targets:
                if not sel.any():
                    continue
                eps, cnd = eval_fn(fn, pts[sel], dind, as_medium)
                base[sel] = 1.0 / eps
                if as_medium and np.any(cnd != 0):
                    if cbase is None:
                        cbase = (np.zeros(self.gv.shape) if crow is None
                                 else np.array(crow, np.float64))
                    cbase[sel] = cnd
            if not np.allclose(base, 1.0):
                mat.chi1inv[c][d_c] = base
            if cbase is not None:
                mat.cond["d" + c[1]] = cbase

    def _apply_epsilon_input(self, mat, live_e):
        """Background epsilon from an HDF5 file (simulation.py
        epsilon_input_file; meepgeom epsilon input): the dataset spans the
        cell and is sampled (multi-linear) at each live E component's Yee
        sites; geometry objects still overlay it."""
        from scipy.ndimage import map_coordinates
        replace_all = False
        if self._eps_override is not None:
            # set_epsilon(): a raw array replaces epsilon EVERYWHERE
            # (structure::set_epsilon role), not just the default medium
            eps_bg = np.asarray(self._eps_override, np.float64)
            replace_all = True
        else:
            import h5py
            with h5py.File(self.epsilon_input_file, "r") as f:
                name = "eps" if "eps" in f else list(f.keys())[0]
                eps_bg = np.asarray(f[name], np.float64)
        gv = self.gv
        lo = [gv.origin[a] for a in range(gv.ndim)]
        span = [max(gv.num[a] * gv.dx, 1e-30) for a in range(gv.ndim)]
        for c in live_e:
            dind = c[1]
            coords = []
            for a in range(gv.ndim):
                cc = gv.comp_coords(c, a)
                frac = (cc - lo[a]) / span[a]
                coords.append(frac * (eps_bg.shape[a] - 1))
            mesh = np.meshgrid(*coords, indexing="ij")
            eps_s = map_coordinates(eps_bg, [m.ravel() for m in mesh],
                                    order=1, mode="nearest")
            eps_s = eps_s.reshape(mesh[0].shape)
            # overlay: keep geometry-object values, replace default-medium
            idx = scene._material_at(
                scene._site_points(gv, c), self.geometry,
                self.default_material)
            row = mat.chi1inv.setdefault(c, {}).get(dind)
            if row is None:
                row = np.ones(eps_s.shape)
            bg = 1.0 / eps_s
            mat.chi1inv[c][dind] = bg if replace_all else np.where(
                idx == -1, bg, row)

    def initialize_field(self, component, func):
        """Set the initial field of `component` from a spatial function
        f(Vector3) -> value (fields::initialize_field, initialize.cpp)."""
        import jax.numpy as jnp
        self.init_sim()
        gv = self.gv
        if component not in self._state["f"]:
            raise ValueError(f"component {component} is not stepped")
        coords = [gv.comp_coords(component, a) for a in range(gv.ndim)]
        mesh = np.meshgrid(*coords, indexing="ij")
        vals = np.zeros(mesh[0].shape, np.complex128)
        it = np.nditer(mesh[0], flags=["multi_index"])
        for _ in it:
            mi = it.multi_index
            pt = [m[mi] for m in mesh]
            v3 = [0.0, 0.0, 0.0]
            for a, d in enumerate(gv.axes):
                v3[{"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}[d]] = pt[a]
            if gv.dim == "1d":
                v3 = [0.0, 0.0, pt[0]]
            vals[mi] = func(Vector3(*v3))
        arr = self._state["f"][component]
        pair = self._plan.real_pair and arr.ndim == self.gv.ndim + 1
        shp = arr.shape[1:] if pair else arr.shape
        out = np.zeros(shp, np.complex128)
        out[tuple(slice(0, s) for s in vals.shape)] = vals
        if not self._plan.complex_fields:
            out = out.real
        if pair:
            new = jnp.asarray(np.stack([out.real, out.imag]), arr.dtype)
        else:
            new = jnp.asarray(out, arr.dtype)
        C = self._plan.coefs
        new = S._apply_mask(self._plan, C, component, new)
        f = {**self._state["f"], component: new}
        st = {**self._state, "f": f}
        # keep the conjugate arrays consistent (the reference memcpys
        # f into f_u at alloc; E and D must agree via D = E/u or the next
        # eh update would overwrite the initialization)
        dc = ("d" if component[0] == "e" else "b") + component[1]
        if dc in f:
            u = C.get(f"{component}:u")
            d_new = new / u if u is not None else new
            d_new = S._apply_mask(self._plan, C, dc, d_new)
            f[dc] = d_new
            if "f_u" in st and dc in st["f_u"]:
                st = {**st, "f_u": {**st["f_u"], dc: d_new}}
            if "f_w" in st and component in st["f_w"]:
                st = {**st, "f_w": {**st["f_w"], component: new}}
        self._state = st

    def integrate_field_function(self, cs, func, center=None, size=None):
        """Integral of func(f1, f2, ...) over a volume
        (fields::integrate, integrate.cpp; python integrate_field_function).
        Component arrays are sampled on the first component's lattice;
        default volume = the whole cell."""
        self.init_sim()
        if size is None:
            size = self.cell_size
        coords, w = self.get_array_metadata(component=cs[0], center=center,
                                            size=size)
        arrs = [np.asarray(self.get_array(component=c, center=center,
                                          size=size, snap=True))
                for c in cs]
        # staggered components have lattices differing by one site per
        # axis; crop everything (and the weights) to the common shape
        # (the reference instead interpolates to the centered grid)
        shp = tuple(min(min(a.shape[i] for a in arrs), w.shape[i])
                    for i in range(w.ndim))
        cut = tuple(slice(0, n) for n in shp)
        vals = func(*[a[cut] for a in arrs])
        return complex(np.sum(np.asarray(vals) * w[cut]))

    def init_sim(self):
        if self._plan is not None:
            return
        from .source import EigenModeSource as _EMS
        ems = [s for s in self.sources if isinstance(s, _EMS)]
        if ems:
            self.sources = [s for s in self.sources
                            if not isinstance(s, _EMS)]
            for s in ems:
                par = s.eig_parity
                if par is not None and not isinstance(par, str):
                    par = None           # component-constant hints: default
                band = int(getattr(s.eig_band, "band", s.eig_band)) \
                    if not hasattr(s.eig_band, "g") else s.eig_band
                if not hasattr(band, "g") and s.eig_kpoint is not None \
                        and self.k_point is not None and band == 1:
                    # oblique planewave launch via eig_kpoint (the
                    # reference's add_eigenmode_source with a kpoint in a
                    # Bloch-periodic cell, mpb.cpp:830): band 1 at the
                    # cell's k is the zeroth-order planewave — route it
                    # through the DiffractedPlanewave injector, which
                    # builds the analytic ky = 2 pi k_t wave
                    band = DiffractedPlanewave(g=(0, 0, 0))
                self.add_eigenmode_source(
                    s.src, s.center, s.size,
                    direction=s.launch_direction(),
                    mode_band=band,
                    amplitude=s.amplitude, eig_parity=par)
        live_e, live_h = self._live_components()
        # geometry objects whose material is a callable (per-object
        # epsilon functions) rasterize as vacuum placeholders; the
        # function values are sampled in afterwards
        fn_objs = {i: g.material for i, g in enumerate(self.geometry)
                   if callable(g.material)}
        geometry = self.geometry
        if fn_objs:
            import dataclasses as _dc
            geometry = [(_dc.replace(g, material=Medium())
                         if callable(g.material) else g)
                        for g in self.geometry]
        mat = scene.rasterize(self.gv, geometry, self.default_material,
                              eps_averaging=self.eps_averaging
                              and not fn_objs,
                              subpixel_n=self.subpixel_n,
                              subpixel_tensor=self.subpixel_tensor,
                              live_e=live_e, live_h=live_h)
        if (self.material_function is not None
                or self.epsilon_func is not None or fn_objs):
            self._apply_material_function(mat, geometry, fn_objs, live_e)
        if self.epsilon_input_file or self._eps_override is not None:
            self._apply_epsilon_input(mat, live_e)
        pmls = []
        absorbers = []
        mirror_dirs = {d for _, d, _ in self._mirrors}
        if self._rot2 is not None:
            # the folded axis keeps the rotation plane at its low side
            mirror_dirs.add(self.gv.axes[self._rot2[0]])
        if self._rot4 is not None:
            # both folded axes keep their rotation planes at the low side
            mirror_dirs.add(self.gv.axes[self._rot4[0]])
            mirror_dirs.add(self.gv.axes[self._rot4[1]])
        for bl in self.boundary_layers:
            dirs = list(self.gv.axes) if bl.direction == ALL else [bl.direction]
            for d in dirs:
                # a mirrored axis keeps the wall (the symmetry plane) at
                # its low side; PML goes on the high side only
                side = bl.side
                if d in mirror_dirs:
                    if side == -1:
                        continue
                    side = +1
                if self.dim == "cyl" and d == "r":
                    # r = 0 is the coordinate axis, not a boundary: an
                    # r-low PML slab would absorb the interior around the
                    # axis (structure.cpp:259 boundary_region::apply
                    # never reaches r<0 sides)
                    if side == -1:
                        continue
                    side = +1
                if isinstance(bl, Absorber):
                    if side != bl.side:
                        bl = dataclasses.replace(bl, side=side)
                    absorbers.append((d, bl))
                else:
                    pmls.append(PMLSpec(d, bl.thickness, side=side,
                                        r_asymptotic=bl.r_asymptotic,
                                        mean_stretch=bl.mean_stretch,
                                        pml_profile_power=bl.pml_profile_power,
                                        pml_profile=getattr(
                                            bl, "pml_profile", None)))
        if absorbers:
            _apply_absorbers(self.gv, mat, absorbers, live_e, live_h)
        for key in getattr(self, "_force_cond_d", ()):
            # design regions with MaterialGrid damping need structural
            # conductivity rows (adjoint/design.py apply writes
            # sigma = damping*u*(1-u) into them per iteration)
            if mat.cond.get(key) is None:
                mat.cond[key] = np.zeros(self.gv.shape)
        srcs = self._build_sources(live_e, live_h)
        srcs += getattr(self, "_extra_srcs", [])
        bloch_k = None
        periodic = self._periodic()
        beta = 0.0
        if self.k_point is not None:
            kv = _v3(self.k_point)
            bloch_k = _vec_to_axes(self.gv, kv)
            if self.dim == "2d" and kv.z != 0.0:
                # special_kz: out-of-plane wavenumber (k_point in units
                # of 2pi/a -> the physical beta = 2 pi k_z)
                beta = 2.0 * np.pi * float(kv.z)
        if getattr(self, "_want_ldos", False):
            for si, sv in enumerate(srcs):
                if sv.component[0] not in "eh":
                    continue
                idx = sv.indices
                lo = idx.min(axis=0)
                hi = idx.max(axis=0) + 1
                region = tuple((int(a), int(b)) for a, b in zip(lo, hi))
                w = np.zeros([b - a for a, b in region], np.complex128)
                for (pt, amp) in zip(idx, sv.amps):
                    w[tuple(p - a for p, (a, b) in zip(pt, region))] += \
                        np.conj(amp)
                self._dft_specs.append(DftSpec(
                    name=f"{self._ldos_name}:{si}", component=sv.component,
                    region=region, weights=w, freqs=self._ldos_freqs,
                    centered=False))
        self._plan = compile_plan(
            self.gv, mat, pmls=pmls, periodic=periodic, bloch_k=bloch_k,
            sources=srcs, dfts=self._dft_specs, courant=self.courant,
            dtype=self.dtype, beta=beta,
            complex_fields=True if self.force_complex_fields else None,
            live_e=live_e, live_h=live_h, m=self.m,
            bfast_scaled_k=(tuple(_v3(self.bfast_scaled_k))
                            if self.bfast_scaled_k is not None else None),
            boundaries=self._boundaries or None,
            rot2=self._rot2,
            rot4=self._rot4,
            mirror_node=tuple((ax_, d_, p_) for ax_, d_, p_
                              in self._mirrors if ax_ in self._mirror_node),
            # x storage padded to a multiple of the device count, so the
            # plan can be sharded over every device (parallel/mesh.py;
            # dead rows are masked).  rot4 wedges keep SQUARE storage in
            # the rotation plane (the ghost is a transposed read)
            pad_to_multiple=((jax.device_count(), 1, 1)
                             if self.gv.dim == "3d" and self._rot4 is None
                             else 1))
        if self._rot4 is not None:
            p_ = self._plan
            if any(sp.has_chi3 or sp.has_nr
                   for sp in p_.eh_specs_e + p_.eh_specs_h):
                raise NotImplementedError(
                    "Rotate4 with chi2/chi3 nonlinear media is not "
                    "supported (the NL neighbor sums do not fold)")
            if any(sp.has_u1 or sp.has_u2
                   for sp in p_.eh_specs_e + p_.eh_specs_h):
                raise NotImplementedError(
                    "Rotate4 with anisotropic epsilon is not supported "
                    "(the OFFDIAG neighbor averages cross the fold)")
            if p_.bfast_k is not None or p_.m:
                raise NotImplementedError(
                    "Rotate4 with BFAST/cylindrical runs is not supported")
            if p_.complex_fields:
                raise NotImplementedError(
                    "Rotate4 needs real fields (phase +/-1 irreps)")
        if self._rot2 is not None:
            p_ = self._plan
            if any(s.has_chi3 or s.has_nr
                   for s in p_.eh_specs_e + p_.eh_specs_h):
                raise NotImplementedError(
                    "Rotate2 with chi2/chi3 nonlinear media is not "
                    "supported (the NL neighbor sums do not fold)")
            if p_.bfast_k is not None or p_.m:
                raise NotImplementedError(
                    "Rotate2 with BFAST/cylindrical runs is not supported")
        self._plan.slab_store = self.slab_store
        if self._plan.complex_fields \
                and os.environ.get("MNT_REAL_PAIR") == "1":
            # real-pair complex storage (opt-in): a leading (re, im)
            # channel axis of real arrays, equal to native complex fields
            # to roundoff (test_real_pair.py)
            self._plan.real_pair = True
        self._state = S.init_state(self._plan)

    # -------------------------------------------------------------- monitors
    def _freqs(self, fcen, df, nfreq):
        if nfreq == 1:
            return np.array([fcen])
        return np.linspace(fcen - df / 2, fcen + df / 2, nfreq)

    def _resolve_decimation(self, decimation_factor, freqs):
        """0 = automatic Nyquist-safe subsampling (dft.cpp:195-216):
        floor(1/(2 dt (f_max + src_f_max))), disabled (1) for nonlinear
        or noisy media where harmonics fall outside the source band."""
        if decimation_factor != 0:
            return int(decimation_factor)
        mats = [g.material for g in self.geometry] + [self.default_material]
        for m in mats:
            if (abs(getattr(m, "chi2", 0)) > 0 or
                    abs(getattr(m, "chi3", 0)) > 0):
                return 1
            for su in (getattr(m, "E_susceptibilities", []) or []):
                if "Noisy" in type(su).__name__:
                    return 1
        f_mon = float(np.max(freqs))
        f_src = 0.0
        srcs = list(self.sources) + [
            sv.src_time if hasattr(sv, "src_time") else sv
            for sv in getattr(self, "_extra_srcs", [])]
        for s in srcs:
            st = getattr(s, "src", None) or getattr(s, "src_time", None) \
                or s
            f0 = getattr(st, "frequency", 0.0) or 0.0
            fw = st.get_fwidth() if hasattr(st, "get_fwidth") else 0.0
            f_src = max(f_src, f0 + 0.5 * fw)
        if f_src == 0.0:
            # no source bandwidth known (e.g. monitors added before
            # eigenmode sources): don't guess
            return 1
        dec = int(np.floor(1.0 / (2 * self.dt * (f_mon + f_src))))
        return max(1, dec)

    def add_flux(self, fcen, df, nfreq, *regions, decimation_factor=0):
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run() "
                               "(plan already compiled)")
        freqs = self._freqs(fcen, df, nfreq)
        live = None  # filter at init; use declared source closure
        name = f"flux{len(self._handles)}"
        specs = []
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size if reg.size is not None
                                else Vector3())
            normal = reg.direction
            if normal is None:
                zero_axes = [self.gv.axes[i] for i, sz in enumerate(size)
                             if sz == 0]
                # the normal is the zero-extent in-plane axis; in 2d a line
                # monitor's normal is the axis with zero extent
                normal = zero_axes[0] if zero_axes else self.gv.axes[0]
            live_cs = self._live_components()
            live = live_cs[0] + live_cs[1]
            # flux density S_n is even under a mirror with n != d, odd for
            # n == d (Poynting vector transforms as a vector)
            center, size, fac = self._fold_region(
                center, size, lambda dd: 1.0 if dd != normal else -1.0)
            specs += self._mirror_fix_dft_specs(M.flux_specs(
                self.gv, f"{name}:{ri}", normal, center,
                size, freqs, weight=reg.weight * fac, live=live,
                decimation=self._resolve_decimation(decimation_factor,
                                                    freqs)))
        self._dft_specs += specs
        h = _FluxHandle(name, freqs)
        h._nregions = len(regions)
        h._sim = self
        self._handles.append(h)
        return h

    def add_dft_fields(self, components, fcen, df, nfreq, center=None,
                       size=None, decimation_factor=0):
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run()")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"dftf{len(self._handles)}"
        c_ax = _vec_to_axes(self.gv, center if center is not None else Vector3())
        s_ax = _vec_to_axes(self.gv, size if size is not None else Vector3())
        folded_axes = {ax for ax, _, _ in self._mirrors}
        if self._rot2 is not None:
            folded_axes.add(self._rot2[0])
        if self._rot4 is not None:
            folded_axes.update(self._rot4[:2])
        for ax in folded_axes:
            if c_ax[ax] - s_ax[ax] / 2 < -1e-9:
                # per-point DFT storage has no scalar fold factor; data in
                # the dropped half would silently come back clamped
                raise ValueError(
                    "add_dft_fields region extends into the dropped half "
                    f"of the folded {self.gv.axes[ax]} axis; restrict it "
                    "to the retained half (get_dft_array values there "
                    "equal the full cell's)")
        for c in components:
            self._dft_specs += M.field_specs(self.gv, f"{name}:{c}", c, c_ax,
                                             s_ax, freqs,
                                             decimation=self._resolve_decimation(decimation_factor, freqs))
        h = _DftFieldsHandle(name, list(components), freqs)
        h._sim = self
        self._handles.append(h)
        return h

    def add_near2far(self, fcen, df, nfreq, *regions, decimation_factor=0,
                     nperiods=1):
        """Record near-surface DTFTs for far-field transforms
        (add_dft_near2far, near2far.cpp:558).

        nperiods > 1 on a Bloch-periodic cell sums 2*nperiods+1 lattice
        images of the near surface (with the Bloch phase per period) in
        the far-field transform (near2far.cpp:609-622 + :370-380), for
        grating radiation patterns."""
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run()")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"n2f{len(self._handles)}"
        live = sum(self._live_components(), [])
        surfaces = []
        periodic = []
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size if reg.size is not None
                                else Vector3())
            normal = reg.direction
            if normal is None:
                zero_axes = [self.gv.axes[i] for i, sz in enumerate(size)
                             if sz == 0]
                normal = zero_axes[0]
            skip_surface = False
            fold_touch_axes = []
            if self._rot2 is not None or self._rot4 is not None:
                folded = []
                if self._rot2 is not None:
                    folded.append(self._rot2[0])
                if self._rot4 is not None:
                    folded += list(self._rot4[:2])
                for i in folded:
                    if center[i] - 0.5 * size[i] < -1e-9:
                        raise ValueError(
                            "near2far with a rotational fold needs the "
                            "near surface in the retained wedge")
            for i, d, phase in self._mirrors:
                lo = center[i] - 0.5 * size[i]
                hi = center[i] + 0.5 * size[i]
                if lo >= -1e-9:
                    continue                       # fully retained
                node = (phase == -1) or (i in self._mirror_node)
                if not node:
                    raise ValueError(
                        f"near2far on a half-offset-aligned {d} mirror "
                        "is not supported; use an even cell count (the "
                        "plane then lands on a grid site)")
                if hi <= 1e-9:
                    # fully in the dropped half: its contribution is the
                    # mirror image of the partner face the (symmetric)
                    # box also carries — nothing to store
                    skip_surface = True
                    break
                if abs(center[i]) > 1e-9:
                    raise ValueError(
                        f"near2far region straddles the {d} mirror "
                        "plane asymmetrically")
                # symmetric straddle: clip to the retained half; the
                # far-field Green's sum adds the mirror image term
                # (handle.mirrors below)
                center[i] = hi / 2
                size[i] = hi
                fold_touch_axes.append((i, d))
            if skip_surface:
                continue
            specs, surfs = M.near2far_specs(self.gv, f"{name}:{ri}", normal,
                                            center, size, freqs,
                                            weight=reg.weight, live=live)
            for i, d in fold_touch_axes:
                # first-row weights on the clipped edge: components whose
                # lattice is half-offset along d got a split edge weight
                # against the (nonexistent) below-plane site — their image
                # covers the full pair, so the first retained row keeps
                # its interior weight; on-plane-lattice components keep
                # the half weight (stored + self-image = (1+s)/2, exact)
                for spec in specs:
                    if spec.region[i][0] != 0:
                        continue
                    if not G.yee_shift(spec.component,
                                       self.gv.dim).get(d, 0):
                        continue
                    w = np.array(spec.weights)
                    if w.shape[i] < 2:
                        continue
                    sl0 = [slice(None)] * w.ndim
                    sl1 = [slice(None)] * w.ndim
                    sl0[i], sl1[i] = 0, 1
                    w[tuple(sl0)] = w[tuple(sl1)]
                    spec.weights = w
            self._dft_specs += specs
            surfaces += surfs
            # periodic image setup (near2far.cpp:609-622): a tangential
            # direction qualifies when the cell is Bloch-periodic along
            # it and the region spans the full cell width
            if nperiods > 1:
                per = self._periodic()
                kv = _vec_to_axes(self.gv, _v3(self.k_point)) \
                    if self.k_point is not None else [0.0] * self.gv.ndim
                n_ax = self.gv.axes.index(normal)
                for ax in range(self.gv.ndim):
                    if ax == n_ax or not per[ax]:
                        continue
                    width = self.gv.num[ax] * self.gv.dx
                    if size[ax] >= width - 1e-9:
                        periodic.append(
                            (ax, int(nperiods),
                             2 * np.pi * kv[ax] * width, width))
        # ambient medium at the first region's center (the reference
        # requires a homogeneous surface medium, near2far.cpp:576)
        eps_amb = 1.0
        if regions:
            c0r = _vec_to_axes(self.gv, regions[0].center)
            pt = np.zeros((1, 3))
            pt[0, :self.gv.ndim] = c0r
            idxm = scene._material_at(pt, self.geometry,
                                      self.default_material)
            eps_amb = float(scene._eps_of(idxm, self.geometry,
                                          self.default_material, 2)[0])
        h = _N2FHandle(name, freqs, surfaces, eps=eps_amb,
                       m=float(self.m or 0.0), periodic=tuple(periodic),
                       mirrors=tuple(
                           (ax_, d_, p_) for ax_, d_, p_ in self._mirrors))
        h._sim = self
        self._handles.append(h)
        return h

    def get_farfield(self, handle, pt) -> np.ndarray:
        """(6, nfreq) = (Ex,Ey,Ez,Hx,Hy,Hz)(w) at a far point
        (dft_near2far::farfield)."""
        from ..analysis.near2far import farfield
        x = _vec_to_axes(self.gv, pt)
        return farfield(handle.surfaces, self._state, handle.freqs, x,
                        self.gv.dim, eps=handle.eps, mu=handle.mu,
                        m=handle.m, periodic=handle.periodic,
                        mirrors=getattr(handle, "mirrors", ()))

    def get_farfields(self, handle, resolution, center=None, size=None):
        """Far fields on a grid (get_farfields_array, near2far.cpp:400)."""
        c_ax = _vec_to_axes(self.gv, center if center is not None else Vector3())
        s_ax = _vec_to_axes(self.gv, size if size is not None else Vector3())
        axes_pts = []
        for lo, hi in ((c - s / 2, c + s / 2) for c, s in zip(c_ax, s_ax)):
            n = max(1, int(round((hi - lo) * resolution)) + 1)
            axes_pts.append(np.linspace(lo, hi, n))
        mesh = np.meshgrid(*axes_pts, indexing="ij")
        shape = mesh[0].shape
        out = np.zeros((6, len(handle.freqs)) + shape, np.complex128)
        for ind in np.ndindex(*shape):
            pt = [m[ind] for m in mesh]
            out[(slice(None), slice(None)) + ind] = self.get_farfield_axes(
                handle, pt)
        return out

    def get_farfield_axes(self, handle, x_axes) -> np.ndarray:
        from ..analysis.near2far import farfield
        return farfield(handle.surfaces, self._state, handle.freqs, x_axes,
                        self.gv.dim, eps=handle.eps, mu=handle.mu,
                        m=handle.m, periodic=handle.periodic,
                        mirrors=getattr(handle, "mirrors", ()))

    def near2far_flux(self, handle, direction, center=None, size=None,
                      resolution=1.0):
        """(nfreq,) Poynting flux through a far surface, from far fields
        evaluated on a `resolution`-spaced grid over the volume
        (dft_near2far::flux, near2far.cpp:506): trapezoid-free uniform
        sum of Re(E x H*) . n times the grid cell area."""
        d = direction if isinstance(direction, str) else "xyz"[direction]
        EH = self.get_farfields(handle, resolution, center=center,
                                size=size)             # (6, nfreq, ...)
        pairs = {"x": ((1, 5), (2, 4)), "y": ((2, 3), (0, 5)),
                 "z": ((0, 4), (1, 3))}[d]
        nfreq = len(handle.freqs)
        F = np.zeros(nfreq)
        flat = EH.reshape(6, nfreq, -1)
        for j, (ei, hi) in enumerate(pairs):
            term = np.real(flat[ei] * np.conj(flat[hi])).sum(axis=-1)
            F += term * (1 - 2 * j)
        # uniform cell measure (near2far.cpp:543 semantics), using the
        # same grid spacing as get_farfields
        s_ax = _vec_to_axes(self.gv, size if size is not None else Vector3())
        dV = 1.0
        for ext in s_ax:
            n = max(1, int(round(ext * resolution)) + 1)
            if n > 1:
                dV *= ext / (n - 1)
        return F * dV

    def _plane_eps(self, n_ax: int, u_ax: int, v_ax: int, c_ax, lo, hi,
                   sel_u, sel_v):
        """Sample epsilon on the three in-plane mode sub-lattices of a
        cross-section plane (normal n_ax at c_ax[n_ax]); returns
        (eps_u, eps_v, eps_n) of shape (len(sel_u), len(sel_v)) at the
        E_{u_ax}, E_{v_ax}, E_{n_ax} in-plane Yee sites."""
        from . import scene as _scene
        gv = self.gv
        comps = {"u": ("e" + "xyz"[u_ax], u_ax),
                 "v": ("e" + "xyz"[v_ax], v_ax),
                 "n": ("e" + "xyz"[n_ax], n_ax)}
        out = {}
        for key, (comp, dind) in comps.items():
            cu = gv.comp_coords(comp, u_ax)[sel_u]
            cv = gv.comp_coords(comp, v_ax)[sel_v]
            uu, vv = np.meshgrid(cu, cv, indexing="ij")
            pts = np.zeros((uu.size, 3))
            pts[:, u_ax] = uu.ravel()
            pts[:, v_ax] = vv.ravel()
            pts[:, n_ax] = c_ax[n_ax]
            idxm = _scene._material_at(pts, self.geometry,
                                       self.default_material)
            eps = _scene._eps_of(idxm, self.geometry, self.default_material,
                                 dind)
            out[key] = np.asarray(eps, np.float64).reshape(uu.shape)
        return out["u"], out["v"], out["n"]

    def _mirror_full_line(self, comp, tang_ax):
        """Full-cell component coordinates along a mirrored tangential
        axis, with each entry's folded-grid index (-1 for dropped-half
        rows).  Mode cross-sections must be solved on the FULL line (the
        reference's MPB solve always sees the unfolded eig_vol,
        mpb.cpp:830); the folded run then injects/overlaps only the
        retained rows — their images are implied by the symmetry ghosts.
        Returns None when tang_ax carries no mirror."""
        if not any(axq == tang_ax for axq, _, _ in self._mirrors):
            return None
        yc = self.gv.comp_coords(comp, tang_ax)
        hi_x = self.gv.num[tang_ax] * self.gv.dx
        if tang_ax not in self._mirror_node:
            hi_x -= 0.5 * self.gv.dx     # half-offset plane alignment
        pos = np.where(yc > 1e-9)[0]
        pos_im = pos[yc[pos] <= hi_x + 1e-9]
        onp = np.where(np.abs(yc) <= 1e-9)[0]   # on-plane rows only;
        # below-plane ghost rows (half-offset alignment keeps one at
        # -dx/2) are already covered by the mirrored images — skip them
        yfull = np.concatenate([-yc[pos_im][::-1], yc[onp], yc[pos]])
        fidx = np.concatenate([np.full(len(pos_im), -1, np.int64),
                               onp, pos])
        return yfull, fidx

    def add_eigenmode_source(self, src, center, size, direction=+1,
                             mode_band=1, amplitude=1.0, eig_parity=None):
        """Launch a waveguide eigenmode (add_eigenmode_source, mpb.cpp:830).

        Solves the cross-section eigenproblem at the source center frequency
        (2D: TM/TE tridiagonal per `eig_parity`; 3D: full-vector
        transverse-E FD, the MPB replacement), then injects the equivalent
        currents J = n x H (electric) and M = -n x E (magnetic) for a
        unidirectional launch.  `direction`: +1 = +normal.
        `eig_parity`: None/'TM' (Ez) or 'TE' (Hz) in 2D (the reference's
        parity-constrained solve, mpb.cpp:322 + maxwell_set_parity)."""
        if self._plan is not None:
            raise RuntimeError("add sources before the first run()")
        from ..analysis.modes import solve_tm_modes
        from . import scene as _scene
        from .source import Source as _Src
        gv = self.gv
        if gv.dim == "3d":
            return self._add_eigenmode_source_3d(src, center, size,
                                                 direction, mode_band,
                                                 amplitude)
        if gv.dim != "2d":
            raise NotImplementedError(
                "eigenmode sources: 2d TM/TE and 3d full-vector")
        if str(eig_parity).upper() == "TE":
            return self._add_eigenmode_source_te(src, center, size,
                                                 direction, mode_band,
                                                 amplitude)
        c_ax = _vec_to_axes(gv, center)
        s_ax = _vec_to_axes(gv, size)
        norm_ax = 0 if s_ax[0] == 0 else 1
        tang_ax = 1 - norm_ax
        # epsilon profile along the line at Ez sites; on a mirrored cell
        # solve on the FULL (unfolded) cross-section — the half line's
        # implicit wall would give the wrong mode (see _mirror_full_line)
        ycoords = gv.comp_coords("ez", tang_ax)
        fidx_line = None
        mfl = self._mirror_full_line("ez", tang_ax)
        if mfl is not None:
            ycoords, fidx_line = mfl
        lo = c_ax[tang_ax] - s_ax[tang_ax] / 2
        hi = c_ax[tang_ax] + s_ax[tang_ax] / 2
        sel = np.where((ycoords >= lo - 1e-9) & (ycoords <= hi + 1e-9))[0]
        pts = np.zeros((len(sel), 3))
        pts[:, tang_ax] = ycoords[sel]
        pts[:, norm_ax] = c_ax[norm_ax]
        idxm = _scene._material_at(pts, self.geometry, self.default_material)
        eps_line = _scene._eps_of(idxm, self.geometry, self.default_material, 2)
        fcen = src.frequency
        if isinstance(mode_band, DiffractedPlanewave):
            # oblique planewave injection (the reference's
            # add_eigenmode_source with a DiffractedPlanewave band):
            # the analytic order-g planewave of the Bloch-periodic cell
            from ..analysis.modes import (planewave_mode_tm,
                                          bloch_planewave_mode_tm)
            g_t = mode_band.g[tang_ax]
            kp_t = tuple(_v3(self.k_point))[tang_ax] \
                if self.k_point is not None else 0.0
            L_mon = len(sel) * gv.dx
            ky = 2 * np.pi * (kp_t + g_t / L_mon)
            ys_loc = (ycoords[sel] - ycoords[sel[0]])
            if float(eps_line.max()) > 1.01 * float(eps_line.min()):
                # stratified source line: the order is the Bloch
                # eigenmode of the layered medium (mpb.cpp:925-1110)
                m = bloch_planewave_mode_tm(fcen, eps_line, ky, ys_loc,
                                            gv.dx, dt=self.dt)
            else:
                eps0 = float(np.median(eps_line))
                m = planewave_mode_tm(fcen, eps0, ky, ys_loc, gv.dx,
                                      dt=self.dt)
            if m is None:
                raise ValueError("requested diffraction order is evanescent "
                                 "at the source frequency")
        else:
            modes = solve_tm_modes(eps_line, gv.dx, fcen,
                                   num_modes=mode_band)
            if len(modes) < mode_band:
                raise ValueError(f"only {len(modes)} guided modes found")
            m = modes[mode_band - 1]
        w = 2 * np.pi * fcen
        sgn = 1.0 if direction > 0 else -1.0
        # J_z and M_y with relative sign chosen so the +normal launch
        # cancels (calibrated against the flux directionality drive)
        jz = -sgn * (m.beta / w) * m.ez
        my = m.ez
        # electric current at Ez sites on the line; on a mirrored cell
        # inject only the retained rows (the symmetry supplies the image)
        if fidx_line is not None:
            keep = np.where(fidx_line[sel] >= 0)[0]
            tang_idx = fidx_line[sel][keep]
        else:
            keep = np.arange(len(sel))
            tang_idx = sel
        npts = len(keep)
        idx_e = np.zeros((npts, 2), np.int32)
        idx_e[:, tang_ax] = tang_idx
        xline = gv.comp_coords("ez", norm_ax)
        ixe = int(np.argmin(np.abs(xline - c_ax[norm_ax])))
        idx_e[:, norm_ax] = ixe
        amps_e = (jz[keep] * amplitude * self.resolution
                  ).astype(np.complex128)
        self._extra_srcs = getattr(self, "_extra_srcs", [])
        self._extra_srcs.append(SrcVolSpec("ez", idx_e, amps_e, src))
        # magnetic current at Hy sites (staggered half cell in x):
        # interpolate each (x0, y_i) onto the hy lattice
        idx_list, amp_list = [], []
        for k, yv in zip(keep, ycoords[sel][keep]):
            pt = [0.0, 0.0]
            pt[norm_ax] = c_ax[norm_ax]
            pt[tang_ax] = yv
            for gidx, wgt in gv.interp_weights("hy", pt):
                idx_list.append(gidx)
                amp_list.append(wgt * my[k] * amplitude * self.resolution)
        idx_h = np.array(idx_list, np.int32)
        amps_h = np.array(amp_list, np.complex128)
        self._extra_srcs.append(SrcVolSpec("hy", idx_h, amps_h, src))
        return m

    def _add_eigenmode_source_te(self, src, center, size, direction,
                                 mode_band, amplitude):
        """2D TE (Hz-polarized) eigenmode source: equivalence currents
        J_y = -Hz_m, M_z = -sgn * Ey_m on the source line (the duality
        image of the TM launch; mpb.cpp:830 with TE parity)."""
        from ..analysis.modes import solve_te_modes
        from . import scene as _scene
        gv = self.gv
        c_ax = _vec_to_axes(gv, center)
        s_ax = _vec_to_axes(gv, size)
        norm_ax = 0 if s_ax[0] == 0 else 1
        tang_ax = 1 - norm_ax
        # epsilon along the line at the Hz/Ey shared tangential lattice
        # (both sit at half-integer tangential sites); mirrored cells
        # solve on the full unfolded line (_mirror_full_line)
        ycoords = gv.comp_coords("hz", tang_ax)
        fidx_line = None
        mfl = self._mirror_full_line("hz", tang_ax)
        if mfl is not None:
            ycoords, fidx_line = mfl
        lo = c_ax[tang_ax] - s_ax[tang_ax] / 2
        hi = c_ax[tang_ax] + s_ax[tang_ax] / 2
        sel = np.where((ycoords >= lo - 1e-9) & (ycoords <= hi + 1e-9))[0]
        pts = np.zeros((len(sel), 3))
        pts[:, tang_ax] = ycoords[sel]
        pts[:, norm_ax] = c_ax[norm_ax]
        idxm = _scene._material_at(pts, self.geometry, self.default_material)
        eps_line = _scene._eps_of(idxm, self.geometry,
                                  self.default_material, 2)
        fcen = src.frequency
        if isinstance(mode_band, DiffractedPlanewave):
            # TE diffraction-order injection (the TM branch's duality
            # image; mpb.cpp add_eigenmode_source with a
            # diffractedplanewave at TE parity): the analytic / layered
            # Bloch order-g planewave of the periodic cell
            from ..analysis.modes import (planewave_mode_te,
                                          bloch_planewave_mode_te)
            g_t = mode_band.g[tang_ax]
            kp_t = tuple(_v3(self.k_point))[tang_ax] \
                if self.k_point is not None else 0.0
            L_mon = len(sel) * gv.dx
            ky = 2 * np.pi * (kp_t + g_t / L_mon)
            ys_loc = (ycoords[sel] - ycoords[sel[0]])
            if float(eps_line.max()) > 1.01 * float(eps_line.min()):
                m = bloch_planewave_mode_te(fcen, eps_line, ky, ys_loc,
                                            gv.dx, dt=self.dt)
            else:
                eps0 = float(np.median(eps_line))
                m = planewave_mode_te(fcen, eps0, ky, ys_loc, gv.dx,
                                      dt=self.dt)
            if m is None:
                raise ValueError("requested diffraction order is evanescent "
                                 "at the source frequency")
        else:
            modes = solve_te_modes(eps_line, gv.dx, fcen,
                                   num_modes=mode_band)
            if len(modes) < mode_band:
                raise ValueError(f"only {len(modes)} guided TE modes found")
            m = modes[mode_band - 1]
        sgn = 1.0 if direction > 0 else -1.0
        e_tan = "e" + ("y" if tang_ax == 1 else "x")
        jy = -m.hz
        mz = -sgn * m.ey
        self._extra_srcs = getattr(self, "_extra_srcs", [])
        if fidx_line is not None:
            keep = np.where(fidx_line[sel] >= 0)[0]
            tang_idx = fidx_line[sel][keep]
        else:
            keep = np.arange(len(sel))
            tang_idx = sel
        # electric current at the tangential-E sites on the line (same
        # tangential lattice as the mode profile)
        npts = len(keep)
        idx_e = np.zeros((npts, 2), np.int32)
        idx_e[:, tang_ax] = tang_idx
        xline = gv.comp_coords(e_tan, norm_ax)
        ixe = int(np.argmin(np.abs(xline - c_ax[norm_ax])))
        idx_e[:, norm_ax] = ixe
        amps_e = (jy[keep] * amplitude * self.resolution
                  ).astype(np.complex128)
        self._extra_srcs.append(SrcVolSpec(e_tan, idx_e, amps_e, src))
        # magnetic current at Hz sites (staggered half cell along normal)
        idx_list, amp_list = [], []
        for k, yv in zip(keep, ycoords[sel][keep]):
            pt = [0.0, 0.0]
            pt[norm_ax] = c_ax[norm_ax]
            pt[tang_ax] = yv
            for gidx, wgt in gv.interp_weights("hz", pt):
                idx_list.append(gidx)
                amp_list.append(wgt * mz[k] * amplitude * self.resolution)
        idx_h = np.array(idx_list, np.int32)
        amps_h = np.array(amp_list, np.complex128)
        self._extra_srcs.append(SrcVolSpec("hz", idx_h, amps_h, src))
        return m

    def get_eigenmode(self, frequency, center, size, band_num=1,
                      eig_parity=None):
        """Solve for a waveguide eigenmode on a cross-section
        (fields::get_eigenmode, mpb.cpp:322): returns the Mode1D (2D
        TM/TE per eig_parity) or Mode2D (3D full-vector) object with
        .freq/.beta/.neff and the field profiles."""
        gv = self.gv
        if gv.dim == "3d":
            from ..analysis.modes import solve_vector_modes
            c_ax = _vec_to_axes(gv, center)
            s_ax = _vec_to_axes(gv, size)
            n_ax = int(np.argmin([abs(s) for s in s_ax]))
            u_ax, v_ax = (n_ax + 1) % 3, (n_ax + 2) % 3
            en_comp = "e" + "xyz"[n_ax]

            def win(ax):
                cc = gv.comp_coords(en_comp, ax)
                lo = c_ax[ax] - s_ax[ax] / 2
                hi = c_ax[ax] + s_ax[ax] / 2
                return np.where((cc >= lo - 1e-9) & (cc <= hi + 1e-9))[0]

            eps_u, eps_v, eps_n = self._plane_eps(
                n_ax, u_ax, v_ax, c_ax, None, None, win(u_ax), win(v_ax))
            modes = solve_vector_modes(eps_u, eps_v, eps_n, gv.dx,
                                       frequency, num_modes=band_num)
        elif gv.dim == "2d":
            from ..analysis.modes import solve_te_modes, solve_tm_modes
            from . import scene as _scene
            te = str(eig_parity).upper() == "TE"
            prof_c = "hz" if te else "ez"
            c_ax = _vec_to_axes(gv, center)
            s_ax = _vec_to_axes(gv, size)
            norm_ax = 0 if s_ax[0] == 0 else 1
            tang_ax = 1 - norm_ax
            ycoords = gv.comp_coords(prof_c, tang_ax)
            lo = c_ax[tang_ax] - s_ax[tang_ax] / 2
            hi = c_ax[tang_ax] + s_ax[tang_ax] / 2
            sel = np.where((ycoords >= lo - 1e-9)
                           & (ycoords <= hi + 1e-9))[0]
            pts = np.zeros((len(sel), 3))
            pts[:, tang_ax] = ycoords[sel]
            pts[:, norm_ax] = c_ax[norm_ax]
            idxm = _scene._material_at(pts, self.geometry,
                                       self.default_material)
            eps = _scene._eps_of(idxm, self.geometry,
                                 self.default_material, 2)
            solver = solve_te_modes if te else solve_tm_modes
            modes = solver(eps, gv.dx, frequency, num_modes=band_num)
        else:
            raise NotImplementedError("get_eigenmode: 2d/3d")
        if len(modes) < band_num:
            raise ValueError(f"only {len(modes)} guided modes found")
        return modes[band_num - 1]

    def _add_eigenmode_source_3d(self, src, center, size, direction,
                                 mode_band, amplitude):
        """3D eigenmode source: full-vector mode of the cross-section,
        injected as the equivalent-current sheet J = n x H, M = -n x E
        in the right-handed transverse frame u=(n+1)%3, v=(n+2)%3."""
        from ..analysis.modes import solve_vector_modes
        gv = self.gv
        c_ax = _vec_to_axes(gv, center)
        s_ax = _vec_to_axes(gv, size)
        n_ax = int(np.argmin([abs(s) for s in s_ax]))
        u_ax, v_ax = (n_ax + 1) % 3, (n_ax + 2) % 3
        en_comp = "e" + "xyz"[n_ax]

        def win(ax):
            cc = gv.comp_coords(en_comp, ax)
            lo = c_ax[ax] - s_ax[ax] / 2
            hi = c_ax[ax] + s_ax[ax] / 2
            return np.where((cc >= lo - 1e-9) & (cc <= hi + 1e-9))[0]

        sel_u, sel_v = win(u_ax), win(v_ax)
        eps_u, eps_v, eps_n = self._plane_eps(n_ax, u_ax, v_ax, c_ax,
                                              None, None, sel_u, sel_v)
        fcen = src.frequency
        modes = solve_vector_modes(eps_u, eps_v, eps_n, gv.dx, fcen,
                                   num_modes=mode_band)
        if len(modes) < mode_band:
            raise ValueError(f"only {len(modes)} guided modes found")
        m = modes[mode_band - 1]
        sgn = 1.0 if direction > 0 else -1.0
        self._extra_srcs = getattr(self, "_extra_srcs", [])

        def inject(comp, prof2d, coord_comp):
            """Scatter a (nu, nv) current profile (sampled at coord_comp's
            in-plane sites) onto comp's 3D lattice."""
            cu = gv.comp_coords(coord_comp, u_ax)[sel_u]
            cv = gv.comp_coords(coord_comp, v_ax)[sel_v]
            idx_list, amp_list = [], []
            for i, uu in enumerate(cu):
                for j, vv in enumerate(cv):
                    a = prof2d[i, j]
                    if a == 0:
                        continue
                    pt = [0.0, 0.0, 0.0]
                    pt[u_ax], pt[v_ax], pt[n_ax] = uu, vv, c_ax[n_ax]
                    for gidx, wgt in gv.interp_weights(comp, pt):
                        idx_list.append(gidx)
                        amp_list.append(wgt * a * amplitude
                                        * self.resolution)
            if idx_list:
                self._extra_srcs.append(SrcVolSpec(
                    comp, np.array(idx_list, np.int32),
                    np.array(amp_list, np.complex128), src))

        eu_c, ev_c = "e" + "xyz"[u_ax], "e" + "xyz"[v_ax]
        hu_c, hv_c = "h" + "xyz"[u_ax], "h" + "xyz"[v_ax]
        # J = n x H flips with launch direction; M = -n x E does not
        # (the backward mode has H reversed), matching the 2D calibration
        inject(eu_c, -sgn * m.hv, eu_c)   # J_u at Eu sites (hv colocated)
        inject(ev_c, sgn * m.hu, ev_c)    # J_v at Ev sites
        inject(hu_c, m.ev + 0j, ev_c)     # M_u at Hu sites ((0, half))
        inject(hv_c, -m.eu + 0j, eu_c)    # M_v at Hv sites ((half, 0))
        return m

    def _get_eigenmode_coefficients_3d(self, flux_handle, bands):
        """3D mode decomposition: un-weight the plane monitor's DTFT pairs
        (pair0 = (E_u, H_v) scale +1, pair1 = (E_v, H_u) scale -1 per
        _FLUX_PAIRS' cyclic convention) and overlap with full-vector
        modes."""
        from ..analysis.modes import solve_vector_modes, mode_overlap_vector
        freqs = flux_handle.freqs
        name = flux_handle.name
        spec_e0 = next(s for s in self._plan.dfts
                       if s.name == f"{name}:0:e0")
        reg = spec_e0.region
        extents = [b - a for a, b in reg]
        n_ax = int(np.argmin(extents))
        u_ax, v_ax = (n_ax + 1) % 3, (n_ax + 2) % 3

        def plane(key_e, key_h):
            dE = _dview(self._state["dft"][key_e])
            dH = _dview(self._state["dft"][key_h])
            spec = next(s for s in self._plan.dfts if s.name == key_e)
            wgt = spec.weights
            w_t = wgt.sum(axis=n_ax)
            w_n = wgt.sum(axis=tuple(a for a in range(3) if a != n_ax))
            w_n = w_n / max(w_n.sum(), 1e-300)
            dE_p = dE.sum(axis=n_ax) / spec.scale
            with np.errstate(divide="ignore", invalid="ignore"):
                E = np.where(w_t[..., None] != 0, dE_p / w_t[..., None],
                             0.0)
            H = np.tensordot(w_n, np.moveaxis(dH, n_ax, 0), axes=1)
            return E, H

        E_u, H_v = plane(f"{name}:0:e0", f"{name}:0:h0")
        E_v, H_u = plane(f"{name}:0:e1", f"{name}:0:h1")
        rem = [a for a in range(3) if a != n_ax]
        if rem[0] != u_ax:   # arrays come out in ascending-axis order
            E_u, H_v, E_v, H_u = (np.swapaxes(A, 0, 1)
                                  for A in (E_u, H_v, E_v, H_u))
        sel_u = np.arange(reg[u_ax][0], reg[u_ax][1])
        sel_v = np.arange(reg[v_ax][0], reg[v_ax][1])
        c_ax = [0.0, 0.0, 0.0]
        c_ax[n_ax] = ((reg[n_ax][0] + 0.5) * self.gv.dx
                      + self.gv.origin[n_ax])
        eps_u, eps_v, eps_n = self._plane_eps(n_ax, u_ax, v_ax, c_ax,
                                              None, None, sel_u, sel_v)
        dA = self.gv.dx ** 2
        alpha = np.zeros((len(bands), len(freqs), 2), np.complex128)
        from ..analysis.modes import planewave_mode_vector
        int_bands = [b for b in bands
                     if not isinstance(b, DiffractedPlanewave)]
        us = (sel_u - sel_u[0]) * self.gv.dx
        vs = (sel_v - sel_v[0]) * self.gv.dx
        Lu, Lv = len(sel_u) * self.gv.dx, len(sel_v) * self.gv.dx
        kp = tuple(_v3(self.k_point)) if self.k_point is not None \
            else (0.0, 0.0, 0.0)
        for fi, f in enumerate(freqs):
            modes = solve_vector_modes(eps_u, eps_v, eps_n, self.gv.dx, f,
                                       num_modes=max(int_bands)) \
                if int_bands else []
            for bi, band in enumerate(bands):
                if isinstance(band, DiffractedPlanewave):
                    ku = 2 * np.pi * (kp[u_ax] + band.g[u_ax] / Lu)
                    kv = 2 * np.pi * (kp[v_ax] + band.g[v_ax] / Lv)
                    eps0 = float(np.median(eps_n))
                    ax3 = tuple(_v3(band.axis)) if band.axis is not None \
                        else tuple(1.0 if i == 2 else 0.0 for i in range(3))
                    # rotate axis into the (n, u, v) frame
                    axf = (ax3[n_ax], ax3[u_ax], ax3[v_ax])
                    s_amp = band.s if (band.s or band.p) else 1.0
                    m = planewave_mode_vector(f, eps0, ku, kv, us, vs,
                                              self.gv.dx, s_amp, band.p,
                                              axis=axf)
                    if m is None:        # evanescent order
                        continue
                else:
                    if len(modes) < band:
                        continue
                    m = modes[band - 1]
                ap, am = mode_overlap_vector(
                    m, E_u[..., fi], E_v[..., fi],
                    H_u[..., fi], H_v[..., fi], dA)
                from ..analysis.modes import monitor_average_boost
                boost = monitor_average_boost(m.beta, self.gv.dx)
                alpha[bi, fi, 0] = ap * boost
                alpha[bi, fi, 1] = am * boost
        return alpha

    def _mode_monitor_ctx(self, flux_handle, te):
        """Extract the cross-section DTFT field lines and the EXACT
        discrete-eigenproblem coefficients from a 2D flux monitor
        (shared by get_eigenmode_coefficients and
        get_bloch_branch_coefficients)."""
        from types import SimpleNamespace
        from . import scene as _scene
        freqs = flux_handle.freqs
        # the flux monitor stores pair0 = (ey, hz) [TE] and pair1 =
        # (ez, hy) [TM, scale -1] for normal x (dft.cpp:600-612)
        pi_ = "0" if te else "1"
        key_e = f"{flux_handle.name}:0:e{pi_}"
        key_h = f"{flux_handle.name}:0:h{pi_}"
        dE = _dview(self._state["dft"][key_e])   # includes -dV weights
        dH = _dview(self._state["dft"][key_h])
        spec_e = next(mspec for mspec in self._plan.dfts
                      if mspec.name == key_e)
        wgt = spec_e.weights
        scale = spec_e.scale
        reg = spec_e.region
        extents = [b - a for a, b in reg]
        tang_ax = int(np.argmax(extents))
        norm_pos = 1 - tang_ax
        # separate the outer-product weights: interpolation along the normal
        # (sums to 1) x integration along the cross-section (x dV)
        w_t_dv = wgt.sum(axis=norm_pos)              # (n_tang,)
        w_n = wgt.sum(axis=tang_ax)
        w_n = w_n / max(w_n.sum(), 1e-300)           # (n_norm,)
        # collapse the normal axis to fields AT the monitor plane
        dE_plane = dE.sum(axis=norm_pos) / scale
        with np.errstate(divide="ignore", invalid="ignore"):
            dE_raw = np.where(w_t_dv[:, None] != 0,
                              dE_plane / w_t_dv[:, None], 0.0)
        dH = np.tensordot(w_n, np.moveaxis(dH, norm_pos, 0), axes=1)
        ys = (np.arange(reg[tang_ax][0], reg[tang_ax][1]) + 0.5) * self.gv.dx             + self.gv.origin[tang_ax]
        mirrored_tang = False
        mir = next(((axq, dq, pq) for axq, dq, pq in self._mirrors
                    if axq == tang_ax), None)
        if mir is not None:
            # folded cell: reconstruct the FULL cross-section lines — the
            # mode overlap must see the whole mode, not the half the
            # retained region stores (reference: symmetry-aware
            # loop_in_chunks feeds the full eig_vol, mpb.cpp:925)
            _, dmir, pmir = mir
            spec_h = next(mspec for mspec in self._plan.dfts
                          if mspec.name == key_h)
            sE = pmir * _mirror_parity(spec_e.component, dmir)
            sH = pmir * _mirror_parity(spec_h.component, dmir)
            pos = np.where(ys > 1e-9)[0]
            onp = np.where(np.abs(ys) <= 1e-9)[0]
            ys = np.concatenate([-ys[pos][::-1], ys[onp], ys[pos]])
            # the on-plane centered row's Yee average saw the zero ghost
            # below the wall: the true full-cell value is (1+s)x the
            # stored half (cf. _mirror_fix_dft_specs; the unweighting
            # above divided the spec's own (1+s) back out)
            dE_raw = np.concatenate(
                [sE * dE_raw[pos][::-1], (1.0 + sE) * dE_raw[onp],
                 dE_raw[pos]])
            # dH keeps its tangential spec weight in the data, so the
            # (1+s) restoration already rode in via _mirror_fix_dft_specs
            dH = np.concatenate([sH * dH[pos][::-1], dH[onp], dH[pos]])
            mirrored_tang = True
        xpos = (reg[1 - tang_ax][0] + 0.5) * self.gv.dx + self.gv.origin[1 - tang_ax]
        pts = np.zeros((len(ys), 3))
        pts[:, tang_ax] = ys
        pts[:, 1 - tang_ax] = xpos
        idxm = _scene._material_at(pts, self.geometry, self.default_material)
        eps_line = _scene._eps_of(idxm, self.geometry, self.default_material, 2)
        kp_t = 0.0
        if self.k_point is not None:
            kp_t = tuple(_v3(self.k_point))[tang_ax]
        strat_line = float(eps_line.max()) > 1.01 * float(eps_line.min())
        eps_line_tm = eps_line
        inv_nodes_line = inv_edges_line = None
        if strat_line:
            # Build the Bloch eigenproblem from the EXACT 1/eps rows the
            # FDTD ran with (the plan's e*:u coefficients, which include
            # subpixel smoothing) — re-rasterizing point samples gives a
            # slightly different operator whose eigenvectors mix the
            # branch projections (measured: per-order conservation
            # between two monitor depths 0.5-1.1x raw vs 1.00 exact).
            def _u_line(name, avg_norm=True):
                if mirrored_tang:
                    # folded region covers half the line; fall back to
                    # the analytic rasterization on the full line
                    return None
                u = self._plan.coefs.get(name)
                if u is None:
                    return None
                u = np.asarray(u)
                # coef storage is the (num+1)-site grid; reject only
                # broadcast-compressed rows that can't cover the region
                if u.ndim != len(reg) or any(
                        b > s for (a, b), s in zip(reg, u.shape)):
                    return None
                blk = u[tuple(slice(a, b) for a, b in reg)]
                blk = np.moveaxis(blk, norm_pos, 0)
                return blk.mean(axis=0) if avg_norm else blk[0]

            if te:
                # nodes = the monitor E component's own sites;
                # edges = the normal-axis E component at integer
                # tangential sites (edge k sits BELOW node k)
                inv_nodes_line = _u_line(spec_e.component + ":u")
                inv_edges_line = _u_line(
                    "e" + self.gv.axes[norm_pos] + ":u", avg_norm=False)
                if inv_nodes_line is None:
                    inv_nodes_line = 1.0 / eps_line
                if inv_edges_line is None:
                    inv_edges_line = np.concatenate(
                        [[2.0 / (eps_line[-1] + eps_line[0])],
                         2.0 / (eps_line[:-1] + eps_line[1:])])
            else:
                u_line = _u_line("ez:u")
                if u_line is not None:
                    eps_line_tm = 1.0 / u_line
                else:
                    # fallback: rasterize at the RAW integer-y Ez sites
                    # (half a pixel below the centered coordinates)
                    pts_tm = np.array(pts)
                    pts_tm[:, tang_ax] -= 0.5 * self.gv.dx
                    idxm_tm = _scene._material_at(pts_tm, self.geometry,
                                                  self.default_material)
                    eps_line_tm = _scene._eps_of(
                        idxm_tm, self.geometry, self.default_material, 2)
        ctx = SimpleNamespace(
            freqs=freqs, dE_raw=dE_raw, dH=dH, ys=ys,
            ys_loc=ys - ys[0], L_mon=len(ys) * self.gv.dx,
            tang_ax=tang_ax, kp_t=kp_t, strat_line=strat_line,
            eps_line=eps_line, eps_line_tm=eps_line_tm,
            inv_nodes=inv_nodes_line, inv_edges=inv_edges_line,
            dE_pw=None, dH_pw=None)

        def deconv_lines():
            # TM lines must be deconvolved from the monitor's tangential
            # centered averaging (ez/hy have integer tangential Yee
            # shifts, so the centered DFT applied a per-harmonic
            # cos(k_g dx/2) filter that mixes the Bloch-branch
            # projections of a stratified line; TE's ey/hz sit at
            # half-integer tangential sites and are never averaged)
            if ctx.dE_pw is None:
                from ..analysis.modes import deconv_centered_line
                kb = 2 * np.pi * ctx.kp_t
                nfreq = len(freqs)
                ctx.dE_pw = np.stack(
                    [deconv_centered_line(dE_raw[:, i], self.gv.dx, kb)
                     for i in range(nfreq)], axis=1)
                ctx.dH_pw = np.stack(
                    [deconv_centered_line(dH[:, i], self.gv.dx, kb)
                     for i in range(nfreq)], axis=1)
            return ctx.dE_pw, ctx.dH_pw

        ctx.deconv_lines = deconv_lines
        return ctx

    def get_eigenmode_coefficients(self, flux_handle, bands,
                                   direction_normal="x", eig_parity=None):
        """S-parameter mode decomposition on a flux monitor
        (get_eigenmode_coefficients, mpb.cpp:925).  Returns alpha of shape
        (len(bands), nfreq, 2) = forward/backward coefficients.
        eig_parity: None/'TM' uses the (ez, hy) pair, 'TE' the (ey, hz)
        pair (parity-constrained solving, mpb.cpp:322)."""
        if self.gv.dim == "3d":
            return self._get_eigenmode_coefficients_3d(flux_handle, bands)
        from ..analysis.modes import (solve_te_modes, solve_tm_modes,
                                      mode_overlap_te, mode_overlap_tm,
                                      planewave_mode_tm)
        te = str(eig_parity).upper() == "TE"
        ctx = self._mode_monitor_ctx(flux_handle, te)
        freqs = ctx.freqs
        dE_raw, dH = ctx.dE_raw, ctx.dH
        ys_loc, L_mon, kp_t = ctx.ys_loc, ctx.L_mon, ctx.kp_t
        tang_ax = ctx.tang_ax
        strat_line = ctx.strat_line
        eps_line, eps_line_tm = ctx.eps_line, ctx.eps_line_tm
        inv_nodes_line, inv_edges_line = ctx.inv_nodes, ctx.inv_edges
        nfreq = len(freqs)
        alpha = np.zeros((len(bands), nfreq, 2), np.complex128)
        dE_pw = dH_pw = None
        for bi, band in enumerate(bands):
            for fi, f in enumerate(freqs):
                if isinstance(band, DiffractedPlanewave):
                    # diffraction order on a Bloch-periodic monitor: the
                    # analytic planewave with ky = 2 pi (k_bloch + g/L)
                    g_t = band.g[tang_ax]
                    ky = 2 * np.pi * (kp_t + g_t / L_mon)
                    if not te and dE_pw is None:
                        dE_pw, dH_pw = ctx.deconv_lines()
                    if strat_line:
                        # stratified monitor line: the order is the
                        # Bloch eigenmode of the layered medium (the
                        # reference solves it via MPB, mpb.cpp:925-1110)
                        from ..analysis.modes import (
                            bloch_planewave_mode_te, bloch_planewave_mode_tm)
                        if te:
                            m = bloch_planewave_mode_te(
                                f, eps_line, ky, ys_loc, self.gv.dx,
                                dt=self.dt, inv_nodes=inv_nodes_line,
                                inv_edges=inv_edges_line)
                        else:
                            m = bloch_planewave_mode_tm(
                                f, eps_line_tm, ky, ys_loc, self.gv.dx,
                                dt=self.dt)
                    elif te:
                        from ..analysis.modes import planewave_mode_te
                        eps0 = float(np.median(eps_line))
                        m = planewave_mode_te(f, eps0, ky, ys_loc,
                                              self.gv.dx, dt=self.dt)
                    else:
                        eps0 = float(np.median(eps_line))
                        m = planewave_mode_tm(f, eps0, ky, ys_loc,
                                              self.gv.dx, dt=self.dt)
                    if m is None:        # evanescent order
                        continue
                else:
                    solver = solve_te_modes if te else solve_tm_modes
                    modes = solver(eps_line, self.gv.dx, f,
                                   num_modes=band)
                    if len(modes) < band:
                        continue
                    m = modes[band - 1]
                if isinstance(band, DiffractedPlanewave) and not te:
                    eF = dE_pw[:, fi]
                    hF = dH_pw[:, fi]
                else:
                    eF = dE_raw[:, fi]
                    hF = dH[:, fi]
                if te:
                    ap, am = mode_overlap_te(m, eF, hF, self.gv.dx)
                else:
                    ap, am = mode_overlap_tm(m, eF, hF, self.gv.dx)
                from ..analysis.modes import monitor_average_boost
                boost = monitor_average_boost(m.beta, self.gv.dx)
                alpha[bi, fi, 0] = ap * boost
                alpha[bi, fi, 1] = am * boost
        return alpha

    def get_bloch_branch_coefficients(self, flux_handle, eig_parity=None):
        """Decompose a 2D flux monitor into ALL propagating Bloch
        branches of its cross-section at the cell's Bloch phase.  Unlike
        diffraction ORDERS (get_eigenmode_coefficients with
        DiffractedPlanewave bands), the branches are the orthogonal
        eigenmodes of the x-uniform output medium and PARTITION the
        monitor flux even when the cross-section is stratified (where
        +/-g harmonics hybridize into standing branches with different
        beta).  eig_parity: None/'TM' decomposes the (ez, hy) pair, 'TE'
        the (ey, hz) pair.  Returns (betas, alpha): betas[nfreq] lists of
        branch propagation constants, alpha[nfreq] matching complex
        arrays of shape (nbranch, 2) = forward/backward coefficients, so
        sum |alpha[:, 0]|^2 - |alpha[:, 1]|^2 ~= get_fluxes."""
        if self.gv.dim != "2d":
            raise NotImplementedError("branch decomposition is 2D only")
        from ..analysis.modes import (bloch_branch_modes_te,
                                      bloch_branch_modes_tm,
                                      mode_overlap_te, mode_overlap_tm,
                                      monitor_average_boost)
        te = str(eig_parity).upper() == "TE"
        ctx = self._mode_monitor_ctx(flux_handle, te=te)
        if te:
            # ey/hz sit at half-integer tangential sites: raw lines are
            # already on the mode lattice (no centered-average deconv)
            dE_pw, dH_pw = ctx.dE_raw, ctx.dH
        else:
            dE_pw, dH_pw = ctx.deconv_lines()
        kb = 2 * np.pi * ctx.kp_t
        betas, alphas = [], []
        for fi, f in enumerate(ctx.freqs):
            if te:
                modes = bloch_branch_modes_te(f, ctx.eps_line, kb,
                                              ctx.ys_loc, self.gv.dx,
                                              dt=self.dt,
                                              inv_nodes=ctx.inv_nodes,
                                              inv_edges=ctx.inv_edges)
            else:
                modes = bloch_branch_modes_tm(f, ctx.eps_line_tm, kb,
                                              ctx.ys_loc, self.gv.dx,
                                              dt=self.dt)
            a = np.zeros((len(modes), 2), np.complex128)
            overlap = mode_overlap_te if te else mode_overlap_tm
            for mi, m in enumerate(modes):
                ap, am = overlap(m, dE_pw[:, fi], dH_pw[:, fi],
                                 self.gv.dx)
                boost = monitor_average_boost(m.beta, self.gv.dx)
                a[mi, 0] = ap * boost
                a[mi, 1] = am * boost
            betas.append(np.array([m.beta for m in modes]))
            alphas.append(a)
        return betas, alphas

    def add_force(self, fcen, df, nfreq, *regions, decimation_factor=0):
        """Maxwell stress-tensor force monitor (add_dft_force).  Each
        region's `direction` is the force component; the surface normal is
        inferred from the zero-extent axis."""
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run()")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"force{len(self._handles)}"
        live = sum(self._live_components(), [])
        for ri, reg in enumerate(regions):
            center = _vec_to_axes(self.gv, reg.center)
            size = _vec_to_axes(self.gv, reg.size if reg.size is not None
                                else Vector3())
            zero_axes = [self.gv.axes[i] for i, sz in enumerate(size)
                         if sz == 0]
            normal = zero_axes[0]
            fd = reg.direction or normal
            # stress tensor T_fn transforms as a rank-2 tensor: parity
            # (-1)^{[f==d] + [n==d]} under a mirror in d
            center, size, fac = self._fold_region(
                center, size,
                lambda dd: (-1.0 if fd == dd else 1.0)
                * (-1.0 if normal == dd else 1.0))
            self._dft_specs += self._mirror_fix_dft_specs(M.force_specs(
                self.gv, f"{name}:{ri}", fd, normal, center, size, freqs,
                weight=reg.weight * fac, live=live))
        h = _FluxHandle(name, freqs)
        h._nregions = len(regions)
        h._sim = self
        self._handles.append(h)
        return h

    def get_forces(self, handle):
        total = None
        for ri in range(getattr(handle, "_nregions", 1)):
            f = M.get_force(self._plan, self._state, f"{handle.name}:{ri}")
            if f is not None:
                total = f if total is None else total + f
        return total

    def add_ldos(self, fcen, df, nfreq, decimation_factor=0):
        """LDOS monitor (dft_ldos.cpp): accumulates the E-field DTFT at the
        source points weighted by conj(source amplitude); assembled against
        the host-computed current spectrum in get_ldos."""
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run()")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"ldos{len(self._handles)}"
        self._ldos_freqs = freqs
        self._ldos_name = name
        # specs are created at init (sources are discretized then); mark it
        self._want_ldos = True
        h = _FluxHandle(name, freqs)
        h._sim = self
        self._handles.append(h)
        return h

    def get_ldos(self, handle=None) -> np.ndarray:
        """ldos(w) = (4/pi) * -1/2 Re[F(w) conj(J(w))] / |J(w)|^2 / Jsum^2
        (dft_ldos::ldos, dft_ldos.cpp:60-79)."""
        freqs = self._ldos_freqs
        dt = self._plan.dt
        out = np.zeros(len(freqs))
        nsteps = self._t
        steps = np.arange(nsteps)
        for si, s in enumerate(self._plan.sources):
            key = f"{self._ldos_name}:{si}"
            if key not in self._state["dft"]:
                continue
            Fdft = _dview(self._state["dft"][key]).reshape(-1, len(freqs)).sum(0)
            # current spectrum at the same convention (dt/sqrt(2pi) sum);
            # magnetic currents sample at n*dt (build_xs / step.cpp:64-106),
            # electric at (n+0.5)*dt — dft_ldos::update handles any source
            # component (dft_ldos.cpp:60-100)
            is_h = s.component[0] == "h"
            tt = (steps + (0.0 if is_h else 0.5)) * dt
            cur = np.asarray([s.src_time.current(t, dt) for t in tt])
            Jsum = float(np.sum(np.abs(np.asarray(s.amps))))
            for fi, f in enumerate(freqs):
                Jdft = np.sum(cur * np.exp(2j * np.pi * f * tt)) * dt / np.sqrt(2 * np.pi)
                scale = 4.0 / np.pi * -0.5 / (Jsum * Jsum)
                out[fi] += scale * np.real(Fdft[fi] * np.conj(Jdft)) / abs(Jdft) ** 2
        return out

    def add_energy(self, fcen, df, nfreq, region, decimation_factor=0):
        """Frequency-domain EM energy in a volume (dft_energy analog)."""
        if self._plan is not None:
            raise RuntimeError("add monitors before the first run()")
        freqs = self._freqs(fcen, df, nfreq)
        name = f"en{len(self._handles)}"
        c_ax = _vec_to_axes(self.gv, region.center)
        s_ax = _vec_to_axes(self.gv, region.size if region.size is not None
                            else Vector3())
        live = sum(self._live_components(), [])
        # energy density u = (E*.D + H*.B)/2 is even under any mirror
        c_ax, s_ax, fac = self._fold_region(c_ax, s_ax, lambda dd: 1.0)
        self._dft_specs += self._mirror_fix_dft_specs(M.energy_specs(
            self.gv, name, c_ax, s_ax, freqs, live=live, weight=fac,
            decimation=self._resolve_decimation(decimation_factor, freqs)))
        h = _FluxHandle(name, freqs)
        h._sim = self
        self._handles.append(h)
        return h

    def get_electric_energy(self, handle):
        return M.get_energy(self._plan, self._state, handle.name, "electric")

    def get_magnetic_energy(self, handle):
        return M.get_energy(self._plan, self._state, handle.name, "magnetic")

    def get_total_energy(self, handle):
        return M.get_energy(self._plan, self._state, handle.name, "total")

    def get_fluxes(self, handle: _FluxHandle) -> np.ndarray:
        total = None
        for ri in range(getattr(handle, "_nregions", 1)):
            f = M.get_flux(self._plan, self._state, f"{handle.name}:{ri}")
            total = f if total is None else total + f
        return total

    def get_flux_data(self, handle):
        """Snapshot the DFT accumulators of a flux monitor
        (get_flux_data, simulation.py; used for scattered-field
        normalization runs)."""
        out = {}
        for key, arr in self._state["dft"].items():
            if key.startswith(handle.name + ":"):
                out[key] = np.asarray(arr).copy()
        return out

    def load_minus_flux_data(self, handle, data):
        """Subtract a normalization run's DFT fields from this monitor
        (load_minus_flux_data): the monitor then measures scattered fields
        only."""
        self.init_sim()
        import jax.numpy as jnp
        dft = dict(self._state["dft"])
        for key, arr in data.items():
            if key in dft:
                dft[key] = dft[key] - jnp.asarray(arr)
        self._state = {**self._state, "dft": dft}

    def load_flux_data(self, handle, data):
        """Replace this monitor's DFT fields with a snapshot
        (load_flux_data)."""
        self.init_sim()
        import jax.numpy as jnp
        dft = dict(self._state["dft"])
        for key, arr in data.items():
            if key in dft:
                dft[key] = jnp.asarray(arr)
        self._state = {**self._state, "dft": dft}

    def save_flux(self, fname, handle):
        """Save a monitor's DFT fields to an .npz (the reference's HDF5
        save_flux role)."""
        np.savez(fname if fname.endswith(".npz") else fname + ".npz",
                 **self.get_flux_data(handle))

    def load_flux(self, fname, handle):
        with np.load(fname if fname.endswith(".npz")
                     else fname + ".npz") as z:
            self.load_flux_data(handle, dict(z))

    def load_minus_flux(self, fname, handle):
        with np.load(fname if fname.endswith(".npz")
                     else fname + ".npz") as z:
            self.load_minus_flux_data(handle, dict(z))

    # same prefix-keyed snapshot mechanics for every DFT monitor type
    # (get_force_data / load_minus_force_data etc. in the reference)
    get_force_data = get_flux_data
    load_minus_force_data = load_minus_flux_data
    get_near2far_data = get_flux_data
    load_minus_near2far_data = load_minus_flux_data
    get_energy_data = get_flux_data
    load_minus_energy_data = load_minus_flux_data
    save_force = save_flux
    load_force = load_flux
    load_minus_force = load_minus_flux
    save_near2far = save_flux
    load_near2far = load_flux
    load_minus_near2far = load_minus_flux

    def get_dft_array(self, handle, component, num_freq=None):
        arr = _dview(self._state["dft"][f"{handle.name}:{component}"])
        if num_freq is not None:
            return arr[..., num_freq]
        return arr

    # ------------------------------------------------------------------ run
    def run(self, *step_funcs, until=None, until_after_sources=None):
        """Run the simulation (simulation.py:4502 / _run_until:2795).

        Supports the step-function DSL (models.run_control): at_every /
        at_beginning / at_end / after_sources(...) / bare callables, Harminv
        collectors (scan-emitted probes), and stop-condition objects for
        `until` (stop_when_fields_decayed / stop_when_dft_decayed)."""
        from . import run_control as RC
        self.init_sim()
        sf = RC.parse_step_funcs(step_funcs)
        last_src = max((s.src.last_time() for s in self.sources), default=0.0)

        stop_cond = None
        if until_after_sources is not None and not isinstance(
                until_after_sources, (int, float)):
            stop_cond = until_after_sources
            t_end = None
            t_min = last_src
        elif until_after_sources is not None:
            t_end = last_src + until_after_sources
            t_min = 0.0
        elif until is None:
            raise ValueError("run() needs until= or until_after_sources=")
        elif isinstance(until, (int, float)):
            t_end = self._t * self.dt + until
            t_min = 0.0
        else:
            stop_cond = until
            t_end = None
            t_min = 0.0

        for fn in sf.begin:
            fn(self)

        # probes for collectors
        probes = []
        for i, (h, _) in enumerate(sf.collectors):
            if getattr(h, "indices", None) is not None:
                # WeightedProbe: explicit site indices + weights (per-step
                # weighted surface integrals, e.g. Casimir DCT stress)
                idx = np.asarray(h.indices, np.int32)
                ws = np.asarray(h.weights)
            else:
                # dropped-half/quadrant points on a symmetry-folded cell
                # map through the fold (component swap + parity factor)
                hc, axc, fac = self._fold_point(h.c, _vec_to_axes(self.gv,
                                                                  h.pt))
                pts = self.gv.interp_weights(hc, axc)
                idx = np.array([p for p, w in pts], np.int32)
                ws = np.array([fac * w for p, w in pts])
                probes.append(S.ProbeSpec(f"hm{i}", hc, idx, ws))
                continue
            probes.append(S.ProbeSpec(f"hm{i}", h.c, idx, ws))
        series = {p.name: [] for p in probes}
        collect_from_step = {}
        for i, (h, after) in enumerate(sf.collectors):
            collect_from_step[f"hm{i}"] = (int(round(last_src / self.dt))
                                           if after else 0)

        # stop conditions with a (c, pt) sample ride an in-scan probe so the
        # decision sees the MAX over each dt window, not one instant
        stop_probe_name = None
        if (stop_cond is not None and hasattr(stop_cond, "check_window")
                and getattr(stop_cond, "c", None) is not None):
            sc, s_axc, s_fac = self._fold_point(
                stop_cond.c, _vec_to_axes(self.gv, stop_cond.pt))
            pts = self.gv.interp_weights(sc, s_axc)
            idx = np.array([p for p, w in pts], np.int32)
            ws = np.array([s_fac * w for p, w in pts])
            stop_probe_name = "stopc"
            probes.append(S.ProbeSpec(stop_probe_name, sc, idx, ws))
            series[stop_probe_name] = []

        # choose block size: smallest callback interval or the whole run
        intervals = [iv for iv, _ in sf.every if iv > 0]
        if stop_cond is not None:
            intervals.append(getattr(stop_cond, "dt", 4.0))
        need_blocks = bool(intervals or sf.every or stop_cond is not None
                           or sf.after_sources_fns)
        if t_end is not None:
            total_steps = max(0, int(round(t_end / self.dt)) - self._t)
        else:
            total_steps = None

        if not need_blocks:
            # fast path: one scan per block, with a bounded block length
            # so a diverging run aborts within one block instead of
            # burning the whole budget (the reference checks EVERY step,
            # step.cpp:138; the per-block plane-sum scalar read is the
            # compiled-loop equivalent — see _check_finite)
            if total_steps:
                guard = int(os.environ.get("MNT_FINITE_BLOCK", "1024"))
                done = 0
                while done < total_steps:
                    n = min(guard, total_steps - done)
                    self._run_steps(n, probes, series)
                    done += n
                    self._check_finite()
            self._finish_collectors(sf, series)
            for fn in sf.end:
                fn(self)
            return

        block_t = min(intervals) if intervals else 4.0
        block_steps = max(1, int(round(block_t / self.dt)))
        last_fire = {id(fn): self.meep_time() for _, fn in sf.every}
        max_steps = total_steps if total_steps is not None else 10 ** 9
        done = 0
        import time as _time
        self._last_progress = (_time.monotonic(), self._t)
        while done < max_steps:
            n = min(block_steps, max_steps - done)
            self._run_steps(n, probes, series)
            done += n
            self._check_finite()
            # step-rate progress line (step.cpp:49-56: every ~4s of wall)
            from .. import verbosity as _vb
            wall, t_then = self._last_progress
            now_wall = _time.monotonic()
            if _vb.meep > 0 and now_wall - wall >= 4.0 \
                    and self._t > t_then:
                rate = (now_wall - wall) / (self._t - t_then)
                print(f"on time step {self._t} "
                      f"(time={self.meep_time():g}), {rate:g} s/step")
                self._last_progress = (now_wall, self._t)
            now = self.meep_time()
            for iv, fn in sf.every:
                if iv <= 0 or now - last_fire[id(fn)] >= iv - 1e-9:
                    fn(self)
                    last_fire[id(fn)] = now
            if now > last_src and sf.after_sources_fns:
                fns = sf.after_sources_fns
                sf.after_sources_fns = []
                for fn in fns:
                    fn(self)
            if stop_cond is not None and now >= t_min:
                if stop_probe_name is not None:
                    window = np.concatenate(
                        [np.asarray(x) for x in series[stop_probe_name]]
                    ) if series[stop_probe_name] else np.zeros(1)
                    series[stop_probe_name] = []
                    if stop_cond.check_window(np.abs(window).max()):
                        break
                elif stop_cond.check(self):
                    break
        self._finish_collectors(sf, series)
        for fn in sf.end:
            fn(self)

    def time_spent_on(self, category: str) -> float:
        return self.timers.time_spent_on(category)

    def print_times(self):
        self.timers.print_times()

    def get_array_metadata(self, component=None, center=None, size=None):
        """(coords per axis, weights) for a get_array region
        (array-metadata analog, meep.hpp:1863)."""
        self.init_sim()
        component = component or "ez"
        c_ax = _vec_to_axes(self.gv, center if center is not None else Vector3())
        s_ax = _vec_to_axes(self.gv, size if size is not None else Vector3())
        coords = []
        weights = []
        for ax in range(self.gv.ndim):
            cs = self.gv.comp_coords(component, ax)
            lo = c_ax[ax] - s_ax[ax] / 2
            hi = c_ax[ax] + s_ax[ax] / 2
            i0 = int(np.searchsorted(cs, lo - 1e-9))
            i1 = max(int(np.searchsorted(cs, hi + 1e-9)), i0 + 1)
            coords.append(cs[i0:i1])
            w = np.ones(i1 - i0)
            if len(w) > 1:
                w[0] = w[-1] = 0.5
            weights.append(w * self.gv.dx if s_ax[ax] > 0 else w)
        w_full = weights[0]
        for w in weights[1:]:
            w_full = np.multiply.outer(w_full, w)
        return coords, w_full

    def _run_steps(self, nsteps, probes, series):
        with self.timers.scope("stepping"):
            return self._run_steps_inner(nsteps, probes, series)

    def _run_steps_inner(self, nsteps, probes, series):
        if probes:
            self._state, ys = S.run(self._plan, self._state, nsteps,
                                    t0=self._t, probes=probes)
            for k in series:
                arr = np.asarray(ys[k])
                if self._plan.real_pair and arr.ndim == 2 \
                        and arr.shape[-1] == 2:
                    arr = arr[:, 0] + 1j * arr[:, 1]
                series[k].append(arr)
        else:
            self._state = S.run(self._plan, self._state, nsteps, t0=self._t)
        self._t += nsteps

    def _finish_collectors(self, sf, series):
        for i, (h, after) in enumerate(sf.collectors):
            chunks = series.get(f"hm{i}", [])
            if not chunks:
                continue
            data = np.concatenate(chunks)
            if after:
                last_src = max((s.src.last_time() for s in self.sources),
                               default=0.0)
                n_skip = max(0, int(round(last_src / self.dt))
                             - (self._t - len(data)))
                data = data[n_skip:]
            h._collect(data, self.dt)
            h._analyze()

    def step(self, nsteps: int = 1):
        self.init_sim()
        self._state = S.run(self._plan, self._state, nsteps, t0=self._t)
        self._t += nsteps

    # ------------------------------------------------------------- accessors
    def meep_time(self) -> float:
        return self._t * self.dt

    def get_array(self, component=None, center=None, size=None,
                  snap: bool = False) -> np.ndarray:
        """Dense array of a field component over a volume (array_slice.cpp
        get_array_slice analog).

        Default (snap=False): the field is interpolated from its Yee sites
        onto the cell's integer lattice (n+1 points per axis, both
        boundaries included) exactly like the reference's array slices, so
        point-by-point comparisons against Meep need no half-pixel
        bookkeeping.  Along axes where the component sits at half-integer
        Yee sites, values are 2-point averages with zero ghosts at the
        boundaries (the dropped not-owned contribution, loop_in_chunks).

        snap=True returns the raw component-lattice array (no interp)."""
        self.init_sim()
        if component == Dielectric:
            return self.get_epsilon()
        if component == Permeability:
            return self.get_mu()
        if component in _DERIVED:
            return self._derived_array(component, center=center,
                                       size=size, snap=snap)
        arr = self._field_np(component)
        # crop padded storage to the live grid
        arr = arr[tuple(slice(0, n + 1) for n in self.gv.num)]
        coords = [self.gv.comp_coords(component, ax)
                  for ax in range(self.gv.ndim)]
        # Rotate4 in-plane components: the rotated quadrants carry the
        # SWAPPED component, so the unfold must run on the RAW Yee
        # lattice (each full-cell site of `component` maps by quarter
        # turns onto a raw wedge site of `component` or its partner) —
        # BEFORE the centered collapse, which then applies on the full
        # cell with the reference's zero outer ghosts
        rot4_inplane = (self._rot4 is not None and len(component) == 2
                        and component[0] in "ehdb"
                        and component[1] != self._rot4[2])
        if rot4_inplane:
            arr, coords = self._unfold_rot4_inplane(component, arr, coords)
        if not snap:
            ys = G.yee_shift(component, self.gv.dim)
            for ax, d in enumerate(self.gv.axes):
                if ys.get(d, 0):
                    # half-integer sites -> integer lattice: pairwise
                    # average with zero ghosts at both ends
                    pad = [(0, 0)] * arr.ndim
                    pad[ax] = (1, 1)
                    padded = np.pad(arr, pad)
                    lo_sl = [slice(None)] * arr.ndim
                    hi_sl = [slice(None)] * arr.ndim
                    lo_sl[ax] = slice(0, -1)
                    hi_sl[ax] = slice(1, None)
                    arr = 0.5 * (padded[tuple(lo_sl)] + padded[tuple(hi_sl)])
                    cs = coords[ax]
                    coords[ax] = np.concatenate(
                        [cs - 0.5 * self.gv.dx,
                         [cs[-1] + 0.5 * self.gv.dx]])
        if not rot4_inplane:
            arr, coords = self._unfold(component, arr, coords)
        if center is None and size is None:
            return arr
        c_ax = _vec_to_axes(self.gv, center if center is not None else Vector3())
        s_ax = _vec_to_axes(self.gv, size if size is not None else Vector3())
        sl = []
        for ax in range(self.gv.ndim):
            lo = c_ax[ax] - s_ax[ax] / 2
            hi = c_ax[ax] + s_ax[ax] / 2
            i0 = int(np.searchsorted(coords[ax], lo - 1e-9))
            i1 = int(np.searchsorted(coords[ax], hi + 1e-9))
            sl.append(slice(i0, max(i1, i0 + 1)))
        return arr[tuple(sl)]

    def _derived_array(self, component, center=None, size=None,
                       snap: bool = False) -> np.ndarray:
        """Poynting flux / energy-density arrays assembled from the
        constituent field slices (monitor.cpp:71 get_field on a
        derived_component, applied pointwise on the slice lattice).
        Components this simulation does not carry contribute zero."""
        have = set(self._state["f"].keys())

        def g(c):
            return self.get_array(c, center=center, size=size, snap=snap)

        def prod(a, b):
            # half-shifted components collapse onto the integer lattice
            # with one extra trailing point per shifted axis: crop both
            # factors to the common leading window (positions align at
            # x = i*dx from the cell's low corner)
            sl = tuple(slice(0, min(na, nb))
                       for na, nb in zip(a.shape, b.shape))
            return np.real(np.conj(a[sl]) * b[sl])

        def acc(out, t, sign=1.0):
            if out is None:
                return sign * t
            sl = tuple(slice(0, min(na, nb))
                       for na, nb in zip(out.shape, t.shape))
            return out[sl] + sign * t[sl]

        if component in _S_TERMS:
            (a1, b1), (a2, b2) = _S_TERMS[component]
            out = None
            if a1 in have and b1 in have:
                out = prod(g(a1), g(b1))
            if a2 in have and b2 in have:
                out = acc(out, prod(g(a2), g(b2)), -1.0)
            if out is None:
                raise ValueError(
                    f"{component}: neither Poynting term's components "
                    "exist on this cell")
            return out
        out = None
        for fam, aux in ((("e",), "d"), (("h",), "b")):
            if component == "d_energy_density" and fam[0] == "h":
                continue
            if component == "h_energy_density" and fam[0] == "e":
                continue
            for c in sorted(have):
                if c[0] != fam[0]:
                    continue
                partner = aux + c[1:]
                if partner not in have:
                    continue
                out = acc(out, prod(g(c), g(partner)))
        if out is None:
            raise ValueError(f"{component}: no field pairs on this cell")
        return 0.5 * out

    def _unfold_rot4_inplane(self, component, arr, coords):
        """Full-cell reconstruction of an in-plane vector component on a
        Rotate4 cell, on the RAW Yee lattice (symmetry.cpp transform /
        vec.hpp:1189-1232 rotate4 applied in reverse).

        With R the +90-degree rotation taking axis a1 into a2 and irrep
        phase p, F(R r) = p rho(R) F(r): pulling a full-cell site back by
        one quarter turn ((X, Y) -> (Y, -X)) swaps the in-plane component
        with its partner and picks up -p (a1-directed) / +p (a2-directed)
        — the same signs as the stepper's ghost reads (step._rot4_ghost).
        The rotation maps the two in-plane Yee sublattices onto each
        other exactly, so every mapped site is an on-lattice read of the
        wedge's `component` (even number of turns) or its x<->y-swapped
        partner (odd)."""
        a1, a2, w, phase = self._rot4
        axes = self.gv.axes
        l1, l2 = axes[a1], axes[a2]
        p = float(phase)
        partner = component[0] + (l2 if component[1] == l1 else l1)
        arr2 = self._field_np(partner)
        arr2 = arr2[tuple(slice(0, n + 1) for n in self.gv.num)]
        coords2 = [self.gv.comp_coords(partner, ax)
                   for ax in range(self.gv.ndim)]
        dx = self.gv.dx
        hi1 = self.gv.num[a1] * dx
        hi2 = self.gv.num[a2] * dx
        cw1, cw2 = coords[a1], coords[a2]
        # phantom sites past the live high edge have no image inside the
        # cell: mirror only the live span into the negative wings
        full1 = np.concatenate(
            [-np.flip(cw1[(cw1 > 1e-12) & (cw1 <= hi1 + 1e-9)]), cw1])
        full2 = np.concatenate(
            [-np.flip(cw2[(cw2 > 1e-12) & (cw2 <= hi2 + 1e-9)]), cw2])
        X = full1[:, None] + 0 * full2[None, :]
        Y = 0 * full1[:, None] + full2[None, :]
        sgn = np.ones_like(X)
        par = np.zeros(X.shape, dtype=int)     # quarter turns applied
        base1 = component[1] == l1
        for _k in range(3):
            neg = (X < -1e-12) | (Y < -1e-12)
            if not np.any(neg):
                break
            cur1 = ((par % 2) == 0) == base1   # a1-directed at this turn
            fac = np.where(cur1, -p, p)
            sgn = np.where(neg, sgn * fac, sgn)
            par = np.where(neg, par + 1, par)
            Xn = np.where(neg, Y, X)           # R^-1: (x, y) -> (y, -x)
            Yn = np.where(neg, -X, Y)
            X, Y = Xn, Yn
        arr = np.asarray(arr)
        arr2 = np.asarray(arr2)

        def take_of(a):
            return np.moveaxis(np.moveaxis(a, a1, 0),
                               a2 if a2 > a1 else a2 + 1, 1)

        def idx(cw, V):
            i = np.clip(np.round((V - cw[0]) / dx).astype(int),
                        0, len(cw) - 1)
            return i, np.abs(V - (cw[0] + i * dx))

        take_c = take_of(arr)
        take_p = take_of(arr2)
        ic1, ec1 = idx(cw1, X)
        ic2, ec2 = idx(cw2, Y)
        ip1, ep1 = idx(coords2[a1], X)
        ip2, ep2 = idx(coords2[a2], Y)
        out_c = take_c[ic1, ic2]
        out_p = take_p[ip1, ip2]
        sel2d = (par % 2) == 0
        # every mapped site must land ON the selected lattice (component
        # for even quarter turns, partner for odd): an off-lattice map
        # (e.g. a phantom-row mismatch between the two Yee lattices at
        # some cell size) must fail loudly, not snap to a neighbor row
        rt_err = np.where(sel2d, np.maximum(ec1, ec2),
                          np.maximum(ep1, ep2))
        if rt_err.max() > dx / 4:
            raise AssertionError(
                "rot4 in-plane unfold: mapped site off-lattice by "
                f"{rt_err.max():.3g} (> dx/4 = {dx / 4:.3g})")
        trail = (1,) * (take_c.ndim - 2)
        sel = sel2d.reshape(par.shape + trail)
        out = np.where(sel, out_c, out_p) * sgn.reshape(sgn.shape + trail)
        out = np.moveaxis(np.moveaxis(out, 1, a2 if a2 > a1
                                      else a2 + 1), 0, a1)
        coords = list(coords)
        coords[a1] = full1
        coords[a2] = full2
        return out, coords

    def _unfold(self, component, arr, coords):
        """Reconstruct the full mirrored cell from the retained half:
        rows above the symmetry plane reflect with sign
        phase * mirror_parity (symmetry.cpp transform applied in reverse).
        On-plane rows are shared; the grid's one below-plane ghost row
        (phase +1 alignment) is dropped."""
        if self._rot4 is not None:
            a1, a2, w, phase = self._rot4
            if component != "eps" and component[1] != w:
                raise NotImplementedError(
                    "get_array of an in-plane component on a Rotate4 "
                    "cell: the rotated quadrants carry the SWAPPED "
                    "component; request the rotation-axis component or "
                    "run without the symmetry")
            # full coords: [-L/2, L/2] on both folded axes; each full
            # site maps into the wedge by k quarter turns and picks up
            # phase^k (F_w(R^k r) = phase^k F_w(r); eps is invariant)
            cw1, cw2 = coords[a1], coords[a2]
            p_eff = 1.0 if component == "eps" else float(phase)
            ys4 = G.yee_shift(component, self.gv.dim) \
                if component != "eps" else {}
            if ys4.get(self.gv.axes[a1], 0):
                # half-shifted (hz-family) collapse: the wedge fold-edge
                # columns were averaged with a ZERO below-fold ghost; the
                # missing half is the C4 image of the OTHER fold edge's
                # half (hz(-dx/2, y) = p hz(y, dx/2)), and the shared
                # corner completes to the (1 + p)^2 quadruple image
                arr = np.asarray(arr).copy()
                T = np.swapaxes(arr.copy(), a1, a2)
                sl0 = [slice(None)] * arr.ndim
                sl0[a1] = 0
                arr[tuple(sl0)] += p_eff * T[tuple(sl0)]
                sl1 = [slice(None)] * arr.ndim
                sl1[a2] = 0
                arr[tuple(sl1)] += p_eff * T[tuple(sl1)]
                slc = [slice(None)] * arr.ndim
                slc[a1] = 0
                slc[a2] = 0
                arr[tuple(slc)] += (p_eff * p_eff) * T[tuple(slc)]
            # phantom collapsed columns past the live high edge have no
            # image inside the cell: mirror only the live span
            hi1 = self.gv.num[a1] * self.gv.dx
            hi2 = self.gv.num[a2] * self.gv.dx
            full1 = np.concatenate(
                [-np.flip(cw1[(cw1 > 1e-12) & (cw1 <= hi1 + 1e-9)]), cw1])
            full2 = np.concatenate(
                [-np.flip(cw2[(cw2 > 1e-12) & (cw2 <= hi2 + 1e-9)]), cw2])
            X = full1[:, None] + 0 * full2[None, :]
            Y = 0 * full1[:, None] + full2[None, :]
            sgn = np.ones_like(X)
            for _k in range(3):
                neg = (X < -1e-12) | (Y < -1e-12)
                if not np.any(neg):
                    break
                Xn = np.where(neg, Y, X)       # R^-1: (x, y) -> (y, -x)
                Yn = np.where(neg, -X, Y)
                sgn = np.where(neg, sgn * p_eff, sgn)
                X, Y = Xn, Yn
            dx = self.gv.dx
            i1 = np.clip(np.round((X - cw1[0]) / dx).astype(int),
                         0, len(cw1) - 1)
            i2 = np.clip(np.round((Y - cw2[0]) / dx).astype(int),
                         0, len(cw2) - 1)
            arr = np.asarray(arr)
            take = np.moveaxis(np.moveaxis(arr, a1, 0), a2 if a2 > a1
                               else a2 + 1, 1)
            out = take[i1, i2] * sgn.reshape(
                sgn.shape + (1,) * (take.ndim - 2))
            out = np.moveaxis(np.moveaxis(out, 1, a2 if a2 > a1
                                          else a2 + 1), 0, a1)
            coords = list(coords)
            coords[a1] = full1
            coords[a2] = full2
            return out, coords
        if self._rot2 is not None:
            fax, lax_, _w, phase = self._rot2
            axes = self.gv.axes
            s = 1.0 if component == "eps" else \
                phase * _mirror_parity(component, axes[fax]) \
                * _mirror_parity(component, axes[lax_])
            ys_f = G.yee_shift(component, self.gv.dim).get(axes[fax], 0) \
                if component != "eps" else 0
            c_ax = coords[fax]
            c_fl = coords[lax_]
            # flip-axis entries beyond the symmetric live span (the
            # centered-average phantom column at a dead high site) have
            # no image inside the grid: reverse the symmetric span and
            # zero the phantom rows
            k_sym = int(np.sum(c_fl <= -c_fl[0] + 1e-9))

            def flip_l(a):
                out = np.zeros_like(a)
                slk = [slice(None)] * a.ndim
                slk[lax_] = slice(0, k_sym)
                out[tuple(slk)] = np.flip(a[tuple(slk)], axis=lax_)
                return out

            pos = np.where(c_ax > 1e-12)[0]
            onp = np.where(np.abs(c_ax) <= 1e-12)[0]
            # the image may only reach down to the original low edge:
            # exclude retained phantom columns past the live high edge
            hi_x = self.gv.num[fax] * self.gv.dx
            pos_im = pos[c_ax[pos] <= hi_x + 1e-9]
            a_pos = np.take(arr, pos, axis=fax)
            # f(-x, y) = s * f(x, -y): reflect in x AND flip the y rows
            img = s * np.flip(flip_l(np.take(arr, pos_im, axis=fax)),
                              axis=fax)
            parts = [img]
            cparts = [-np.flip(c_ax[pos_im])]
            if len(onp):
                a_on = np.take(arr, onp, axis=fax)
                if ys_f:
                    # fold-offset-1/2 component: the centered on-plane
                    # column was averaged with a ZERO ghost; the true
                    # ghost is the C2 image of the first half-site, so
                    # the missing half is s * flip of what we have
                    a_on = a_on + s * flip_l(a_on)
                parts.append(a_on)
                cparts.append(c_ax[onp])
            parts.append(a_pos)
            cparts.append(c_ax[pos])
            arr = np.concatenate(parts, axis=fax)
            coords = list(coords)
            coords[fax] = np.concatenate(cparts)
            return arr, coords
        for ax, d, phase in self._mirrors:
            s = 1.0 if component == "eps" else \
                phase * _mirror_parity(component, d)
            c_ax = coords[ax]
            pos = np.where(c_ax > 1e-12)[0]
            onp = np.where(np.abs(c_ax) <= 1e-12)[0]
            # node alignment: the image may only reach down to the full
            # cell's low edge — a half-offset overhang site past the fold
            # extent (hi = extent + dx/2) has no mirror partner
            if ax in self._mirror_node:
                hi_x = self.gv.num[ax] * self.gv.dx
                pos_im = pos[c_ax[pos] <= hi_x + 1e-9]
            else:
                pos_im = pos
            a_pos = np.take(arr, pos, axis=ax)
            parts = [s * np.flip(np.take(arr, pos_im, axis=ax), axis=ax)]
            cparts = [-np.flip(c_ax[pos_im])]
            if len(onp):
                a_on = np.take(arr, onp, axis=ax)
                if ax in self._mirror_node and G.yee_shift(
                        component, self.gv.dim).get(d, 0) \
                        and component != "eps":
                    # node-aligned fold, half-offset component: the
                    # centered on-plane column was averaged with a ZERO
                    # below-plane ghost; the true ghost is the mirror
                    # image of the first half-site, i.e. s * itself
                    a_on = a_on * (1.0 + s)
                parts.append(a_on)
                cparts.append(c_ax[onp])
            parts.append(a_pos)
            cparts.append(c_ax[pos])
            arr = np.concatenate(parts, axis=ax)
            coords = list(coords)
            coords[ax] = np.concatenate(cparts)
        return arr, coords

    def get_epsilon_grid(self, xtics=None, ytics=None, ztics=None
                         ) -> np.ndarray:
        """Smoothed epsilon interpolated onto an arbitrary Cartesian
        grid (the reference's get_epsilon_grid, python/simulation.py /
        meepgeom.cpp:2728 get_epsilon_grid): multilinear interpolation
        of the simulation's own (subpixel-smoothed) epsilon array, so
        the values match what the stepper actually uses.  Absent-axis
        tics collapse; returns shape (len(xtics), len(ytics),
        len(ztics))."""
        self.init_sim()
        eps = np.asarray(self.get_epsilon())
        # reconstruct the epsilon array's lattice: get_epsilon samples
        # the first live E component's (possibly unfolded) lattice —
        # uniform with the component's Yee offsets from the full cell
        # origin
        live_e = [s.ec for s in self._plan.eh_specs_e]
        c = live_e[0] if live_e else "ez"
        ys = G.yee_shift(c, self.gv.dim)
        cs = _v3(self.cell_size)
        cell = [cs.x, cs.y, cs.z]
        dx = self.gv.dx
        slot_of = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}
        axes_coords = []
        slots = []
        for ax, d in enumerate(self.gv.axes):
            n = eps.shape[ax]
            slot = slot_of[d]
            org = -cell[slot] / 2 if self.gv.dim != "cyl" else 0.0
            axes_coords.append(org + (np.arange(n) + 0.5 * ys[d]) * dx)
            slots.append(slot)
        tics = [np.atleast_1d(np.asarray(t, np.float64))
                if t is not None else np.zeros(1)
                for t in (xtics, ytics, ztics)]
        qs = [tics[slot] for slot in slots]
        # multilinear interpolation, clamped at the lattice edges
        out = eps
        for ax, (coords, q) in enumerate(zip(axes_coords, qs)):
            f = np.clip((q - coords[0]) / dx, 0.0, len(coords) - 1.0)
            i0 = np.minimum(f.astype(int), len(coords) - 2) \
                if len(coords) > 1 else np.zeros(len(q), int)
            w = (f - i0) if len(coords) > 1 else np.zeros(len(q))
            a = np.take(out, i0, axis=ax)
            b = np.take(out, np.minimum(i0 + 1, len(coords) - 1), axis=ax)
            shape = [1] * out.ndim
            shape[ax] = len(q)
            w = w.reshape(shape)
            out = a * (1 - w) + b * w
        # arrange to (x, y, z) tics order (grid axes are slot-ordered for
        # every grid kind: 1d = z, 2d = xy, 3d = xyz, cyl = rz)
        assert list(slots) == sorted(slots)
        full = out
        for slot in (0, 1, 2):
            if slot not in slots:
                full = np.expand_dims(full, axis=slot)
        return np.broadcast_to(full, tuple(len(t) for t in tics)).copy()

    def get_epsilon(self) -> np.ndarray:
        self.init_sim()
        live_e = [s.ec for s in self._plan.eh_specs_e]
        c = live_e[0] if live_e else "ez"
        if self._rot4 is not None:
            # unfolding needs a component whose lattice is INTEGER on
            # both folded axes (the quadrant map permutes them); prefer
            # the rotation-axis component
            a1, a2, w, _ph = self._rot4
            good = [cc for cc in live_e
                    if G.yee_shift(cc, self.gv.dim).get(
                        self.gv.axes[a1], 0) == 0
                    and G.yee_shift(cc, self.gv.dim).get(
                        self.gv.axes[a2], 0) == 0]
            c = good[0] if good else c
        key = f"{c}:u"
        if key in self._plan.coefs:
            u = np.asarray(self._plan.coefs[key])
            u = u[tuple(slice(0, n + 1) for n in self.gv.num)]
            eps = 1.0 / np.maximum(u, 1e-300)
        else:
            eps = np.ones(self.gv.shape)
        if self._mirrors or self._rot2 is not None \
                or self._rot4 is not None:
            if self._rot4 is not None and G.yee_shift(
                    c, self.gv.dim).get(self.gv.axes[self._rot4[0]], 0):
                return eps       # no integer-lattice component (2D TE)
            coords = [np.asarray(self.gv.comp_coords(c, ax))
                      for ax in range(self.gv.ndim)]
            eps, _ = self._unfold("eps", eps, coords)
        return eps

    def get_mu(self) -> np.ndarray:
        """Permeability grid at the first live H component's lattice
        (identity unless mu materials are present)."""
        self.init_sim()
        live_h = [s.ec for s in self._plan.eh_specs_h]
        c = live_h[0] if live_h else "hz"
        key = f"{c}:u"
        if key in self._plan.coefs:
            u = np.asarray(self._plan.coefs[key])
            u = u[tuple(slice(0, n + 1) for n in self.gv.num)]
            return 1.0 / np.maximum(u, 1e-300)
        return np.ones(self.gv.shape)

    def _field_np(self, c, state=None) -> np.ndarray:
        """Host view of a field component, recombining the real-pair
        channel axis into a complex array when plan.real_pair."""
        if state is None and c[0] in "hb":
            # synchronized_magnetic(...) step funcs: serve H/B averaged
            # onto E's time grid (fields::synchronize_magnetic_fields)
            ov = getattr(self, "_hb_override", None)
            if ov is not None and c in ov:
                return ov[c]
        st = state if state is not None else self._state
        if c not in st["f"] and len(c) == 2 and c[0] in "ehdb" \
                and c[1] in "xyzrp":
            # a valid component this simulation does not carry (e.g. Ex
            # on a 2D TM cell): the reference's array slices return
            # zeros for unallocated fields
            any_arr = next(iter(st["f"].values()))
            return np.zeros(np.asarray(any_arr.shape)[-self.gv.ndim:],
                            dtype=np.float64)
        arr = np.asarray(st["f"][c])
        if self._plan.real_pair and arr.ndim == self.gv.ndim + 1:
            return arr[0] + 1j * arr[1]
        return arr

    def get_field_point(self, component, pt) -> complex:
        self.init_sim()
        if component in _DERIVED:
            # monitor.cpp:71: derived quantities from interpolated
            # constituent fields at the same point
            have = set(self._state["f"].keys())

            def g(c):
                return self.get_field_point(c, pt) if c in have else 0.0

            if component in _S_TERMS:
                (a1, b1), (a2, b2) = _S_TERMS[component]
                return (np.conj(g(a1)) * g(b1)
                        - np.conj(g(a2)) * g(b2)).real
            tot = 0.0
            for c in sorted(have):
                if c[0] == "e" and component != "h_energy_density":
                    tot += (np.conj(g(c)) * g("d" + c[1:])).real
                if c[0] == "h" and component != "d_energy_density":
                    tot += (np.conj(g(c)) * g("b" + c[1:])).real
            return 0.5 * tot
        component, axc, fac = self._fold_point(
            component, _vec_to_axes(self.gv, pt))
        pts = self.gv.interp_weights(component, axc)
        if component not in self._state["f"]:
            # a Rotate4 fold can swap in-plane components; match
            # _field_np's zeros-for-unallocated semantics instead of
            # KeyError on a cell that carries only one pair member
            return 0.0 * fac
        arr = self._state["f"][component]
        # index on-device, transfer scalars only (no full-array copy to
        # the host for a point query)
        if self._plan.real_pair and arr.ndim == self.gv.ndim + 1:
            return fac * sum(w * (complex(arr[(0,) + idx])
                                  + 1j * complex(arr[(1,) + idx]))
                             for idx, w in pts)
        return fac * sum(w * complex(arr[idx]) for idx, w in pts)

    def _fold_point(self, component, c):
        """Map a query point into the retained fold of a symmetric cell
        (symmetry.cpp transform semantics applied in reverse, as the
        reference's symmetry-aware loop_in_chunks does for point
        queries): mirrors reflect with phase * component parity, Rotate2
        maps through the C2 image (double flip), Rotate4 applies quarter
        turns with the swapped-component rotation-matrix signs
        (step._rot4_ghost).  Returns (component', axes-coords', factor)
        with F_component(pt) == factor * F_component'(pt')."""
        c = list(c)
        fac = 1.0
        axes = self.gv.axes
        for ax, d, phase in self._mirrors:
            if c[ax] < -1e-12:
                c[ax] = -c[ax]
                fac *= phase * _mirror_parity(component, d)
        if self._rot2 is not None:
            fax, lax_, _w, phase = self._rot2
            if c[fax] < -1e-12:
                c[fax] = -c[fax]
                c[lax_] = -c[lax_]
                fac *= phase * _mirror_parity(component, axes[fax]) \
                    * _mirror_parity(component, axes[lax_])
        if self._rot4 is not None:
            a1, a2, _w, phase = self._rot4
            l1, l2 = axes[a1], axes[a2]
            p = float(phase)
            for _k in range(3):
                if c[a1] >= -1e-12 and c[a2] >= -1e-12:
                    break
                c[a1], c[a2] = c[a2], -c[a1]   # R^-1: (x, y) -> (y, -x)
                if component[1] == l1:
                    fac *= -p
                    component = component[0] + l2
                elif component[1] == l2:
                    fac *= p
                    component = component[0] + l1
                elif component[1] == _w:
                    # rotation-axis-directed raw field: invariant up to
                    # the irrep phase
                    fac *= p
                else:
                    raise ValueError(
                        f"_fold_point: component {component!r} has no "
                        "Rotate4 transform rule (derived components "
                        "must be folded per raw constituent)")
        return component, c, fac

    @property
    def fields_state(self):
        return self._state

    @property
    def plan(self):
        return self._plan

    # ---------------- instantaneous (time-domain) energy & flux -----------
    # (energy_and_flux.cpp:54 field_energy_in_box, :217 flux_in_box, with
    # synchronize_magnetic_fields, meep.hpp:2209)

    def _synchronized_hb(self):
        """H and B averaged between t-dt/2 and t+dt/2 — i.e. synchronized
        with E's time t — by stepping a copy one step and averaging
        (2nd-order accurate; synchronize_magnetic_fields analog)."""
        st2 = S.run(self._plan, self._state, 1, t0=self._t)
        out = {}
        for c in self._state["f"]:
            if c[0] in "hb":
                out[c] = 0.5 * (self._field_np(c)
                                + self._field_np(c, st2))
        return out

    def _box_integral(self, comp_for_grid, values, center, size):
        """Integrate a centered-grid array over a box using trapezoid
        weights (get_array_metadata)."""
        coords, w = self.get_array_metadata(component=comp_for_grid,
                                            center=center, size=size)
        sl = []
        for ax in range(self.gv.ndim):
            cs = self.gv.comp_coords(comp_for_grid, ax)
            i0 = int(np.searchsorted(cs, coords[ax][0] - 1e-12))
            sl.append(slice(i0, i0 + len(coords[ax])))
        return float(np.sum(values[tuple(sl)] * w))

    def _centered(self, c, arr):
        return np.asarray(S._centered_avg(self._plan, c, jnp.asarray(arr)))

    def electric_energy_in_box(self, center=None, size=None):
        """(1/2) integral of E . D over the box, instantaneous
        (energy_and_flux.cpp:100)."""
        self.init_sim()
        if size is None:
            size = self.cell_size
        total = 0.0
        for s in self._plan.eh_specs_e:
            e = self._centered(s.ec, np.real(self._field_np(s.ec)))
            d = self._centered(s.dc, np.real(self._field_np(s.dc)))
            total += 0.5 * self._box_integral(s.ec, e * d, center, size)
        return total

    def magnetic_energy_in_box(self, center=None, size=None):
        """(1/2) integral of H . B over the box with synchronized magnetic
        fields (energy_and_flux.cpp:113)."""
        self.init_sim()
        if size is None:
            size = self.cell_size
        hb = self._synchronized_hb()
        total = 0.0
        for s in self._plan.eh_specs_h:
            h = self._centered(s.ec, np.real(hb[s.ec]))
            b = self._centered(s.dc, np.real(hb[s.dc]))
            total += 0.5 * self._box_integral(s.ec, h * b, center, size)
        return total

    def field_energy_in_box(self, center=None, size=None):
        """Total instantaneous EM energy in the box
        (energy_and_flux.cpp:54)."""
        return self.electric_energy_in_box(center, size) \
            + self.magnetic_energy_in_box(center, size)

    def flux_in_box(self, direction, center=None, size=None):
        """Instantaneous Poynting flux integral (E x H_sync) . d over the
        box (energy_and_flux.cpp:217)."""
        self.init_sim()
        if size is None:
            size = self.cell_size
        d = direction if isinstance(direction, str) else "xyz"[direction]
        cyc = {"x": ("y", "z"), "y": ("z", "x"), "z": ("x", "y"),
               "r": ("p", "z"), "p": ("z", "r")}
        p, q = cyc[d]
        hb = self._synchronized_hb()
        f = self._state["f"]

        def get(c, bank):
            if c not in bank:
                return None
            if bank is f:
                return self._centered(c, np.real(self._field_np(c)))
            return self._centered(c, np.real(np.asarray(bank[c])))

        ep_, eq_ = get("e" + p, f), get("e" + q, f)
        hp_, hq_ = get("h" + p, hb), get("h" + q, hb)
        grid_c = next(s.ec for s in self._plan.eh_specs_e)
        total = 0.0
        if ep_ is not None and hq_ is not None:
            total += self._box_integral(grid_c, ep_ * hq_, center, size)
        if eq_ is not None and hp_ is not None:
            total -= self._box_integral(grid_c, eq_ * hp_, center, size)
        return total

    def _check_finite(self):
        """Per-block NaN/Inf abort (step.cpp:138: the reference probes the
        energy density at the cell center every step and aborts).

        Sums one mid-plane of the first stepped component on-device and
        reads back ONE scalar: any
        NaN/Inf anywhere in the plane poisons the sum (Inf-Inf -> NaN),
        so divergence is caught without a full-array transfer."""
        c = next(iter(self._state["f"]))
        arr = self._state["f"][c]
        sl = [slice(None)] * arr.ndim
        sl[arr.ndim - self.gv.ndim] = arr.shape[arr.ndim - self.gv.ndim] // 2
        v = complex(jnp.sum(arr[tuple(sl)]))
        if not (np.isfinite(v.real) and np.isfinite(v.imag)):
            raise RuntimeError(
                "simulation fields are NaN or Inf (step.cpp:138 abort)")

    def solve_cw(self, tol=1e-6, maxiters=2000, freq=None):
        """Frequency-domain steady-state solve (solve_cw,
        cw_fields.cpp:142).  Uses the CW source frequency by default;
        requires force_complex_fields=True."""
        from ..analysis.cw import solve_cw as _solve
        self.init_sim()
        if freq is None:
            freqs = [s.src.frequency for s in self.sources
                     if hasattr(s.src, "frequency")]
            if not freqs:
                raise ValueError("solve_cw needs a source frequency")
            freq = freqs[0]
        out = _solve(self._cw_plan(), freq, tol=tol, max_iters=maxiters)
        for k in ("f", "f_u", "f_cond", "f_w", "pol"):
            if k in out:
                self._state = {**self._state, k: self._pairify(out[k])}
        return out

    def _cw_plan(self):
        """Frequency-domain solves run complex-native (BiCGSTAB on the
        complex step operator); hand them a complex-path plan copy when
        the time-domain state is real-pair."""
        if not self._plan.real_pair:
            return self._plan
        return dataclasses.replace(self._plan, real_pair=False)

    def _pairify(self, tree):
        """Convert complex arrays in a state subtree to the real-pair
        channel layout of the time-domain state."""
        if not self._plan.real_pair:
            return tree
        import jax

        def conv(a):
            if jnp.iscomplexobj(a):
                return jnp.stack([jnp.real(a), jnp.imag(a)]).astype(
                    self._plan.dtype)
            return a
        return jax.tree.map(conv, tree)

    def solve_eigfreq(self, freq=None, tol=1e-6, maxiters=12,
                      cwtol=1e-8, cwmaxiters=4000):
        """Frequency-domain eigensolver: resonant complex eigenfrequency
        nearest `freq` (default: the source frequency) by shift-invert
        power iteration on the step operator (the reference's
        solve_cw-based eigensolver).  Returns a dict with freq, decay, Q,
        eigfreq, and the mode fields; the simulation state is set to the
        mode.  Requires force_complex_fields=True."""
        from ..analysis.cw import solve_eigfreq as _solve
        self.init_sim()
        if freq is None:
            freqs = [s.src.frequency for s in self.sources
                     if hasattr(s.src, "frequency")]
            if not freqs:
                raise ValueError("solve_eigfreq needs a guess frequency")
            freq = freqs[0]
        out = _solve(self._cw_plan(), freq, eig_tol=tol, eig_iters=maxiters,
                     cw_tol=cwtol, cw_iters=cwmaxiters)
        self._state = {**self._state, **self._pairify(out["mode"])}
        return out

    # -------------------------------------------- reference-API parity tail
    # (python/simulation.py Simulation methods not covered elsewhere; each
    # cites its reference line range in the docstring)

    def timestep(self) -> int:
        """Elapsed timesteps (simulation.py:2625)."""
        self.init_sim()
        return self._t

    def round_time(self) -> float:
        """Simulation time rounded to the timestep grid
        (fields::round_time)."""
        return self.meep_time()

    def using_real_fields(self) -> bool:
        """Whether this run steps real fields (simulation.py
        using_real_fields)."""
        cond1 = self.dim == "cyl" and self.m != 0
        cond2 = any(getattr(s, "phase", 1).imag for s in self.symmetries
                    if hasattr(s, "phase"))
        kp = _v3(self.k_point) if self.k_point is not None else None
        cond3 = kp is None
        cond4 = (kp is not None and self.dim == "2d"
                 and kp.x == 0 and kp.y == 0)
        cond5 = not (cond3 or cond4 or (kp is not None and tuple(kp)
                                        == (0.0, 0.0, 0.0)))
        return not (self.force_complex_fields or cond1 or cond2 or cond5)

    def require_dimensions(self):
        """Record the inferred dimensionality (simulation.py
        require_dimensions; dimensions are fixed at construction here)."""
        self.dimensions = {"1d": 1, "2d": 2, "3d": 3, "cyl": -2}[self.dim]
        return self.dimensions

    def has_mu(self) -> bool:
        """True if any material carries a non-identity permeability
        (simulation.py has_mu)."""
        def _mu(medium):
            if not isinstance(medium, Medium):
                return False
            if tuple(medium.mu_diag_vec()) != (1.0, 1.0, 1.0):
                return True
            return bool(getattr(medium, "H_susceptibilities", ()))
        return any(_mu(getattr(g, "material", None)) for g in self.geometry) \
            or any(_mu(m) for m in self.extra_materials) \
            or _mu(self.default_material)

    def get_estimated_memory_usage(self) -> int:
        """Bytes held by the field state (simulation.py
        get_estimated_memory_usage; exact rather than estimated — the
        state pytree is dense and already allocated)."""
        self.init_sim()
        import jax
        return sum(np.prod(v.shape) * v.dtype.itemsize
                   for v in jax.tree_util.tree_leaves(self._state)
                   if hasattr(v, "shape"))

    def get_estimated_costs(self):
        """Per-shard stepping cost (structure::estimated_cost): uniform
        GSPMD shards make every shard's cost cells/n."""
        import jax
        n = max(jax.device_count(), 1)
        cells = float(np.prod(self.gv.num))
        return [cells / n] * n

    def _get_chunk_communication_areas(self):
        import jax
        n = max(jax.device_count(), 1)
        if n == 1:
            return [0.0]
        # uniform 1-d split over the leading axis: each interior boundary
        # exchanges one plane of every stepped component, both directions
        plane = float(np.prod(self.gv.num[1:])) if self.gv.ndim > 1 else 1.0
        ncomp = len(self._state["f"]) if self._state else 6
        return [2 * plane * ncomp] * (n - 1)

    def get_max_chunk_communication_area(self):
        """Maximum inter-chunk halo area (simulation.py:
        get_max_chunk_communication_area)."""
        return max(self._get_chunk_communication_areas())

    def get_avg_chunk_communication_area(self):
        import jax
        return (sum(self._get_chunk_communication_areas())
                / max(jax.device_count(), 1))

    # -- filename prefix / output directory --------------------------------
    def get_filename_prefix(self) -> str:
        """Prefix prepended to output file names (simulation.py
        get_filename_prefix): the script name minus .py unless
        filename_prefix is set ('' disables)."""
        if isinstance(self.filename_prefix, str):
            return self.filename_prefix
        if self.filename_prefix is None:
            import sys
            fname = os.path.split(sys.argv[0])[1]
            return fname[:-3] + "-" if fname.endswith(".py") else ""
        raise TypeError("filename_prefix must be a string or None")

    def use_output_directory(self, dname: str = ""):
        """Send all output files to a (created) subdirectory
        (simulation.py use_output_directory)."""
        if not dname:
            dname = self.get_filename_prefix() + "-out"
            self.filename_prefix = None
        os.makedirs(dname, exist_ok=True)
        self._output_dir = dname
        return dname

    # -- structure mutation -------------------------------------------------
    def _uninitialize(self):
        self._plan = None
        self._state = None
        self._t = 0

    def _rebuild_preserving_fields(self):
        """Re-derive the plan from the current scene attributes, carrying
        shape-compatible state arrays (incl. DFT accumulators) over."""
        old_state, old_t = self._state, self._t
        self._uninitialize()
        self.init_sim()
        if old_state is not None:
            def merge(new, old):
                if isinstance(new, dict) and isinstance(old, dict):
                    return {k: (merge(new[k], old[k]) if k in old else new[k])
                            for k in new}
                if hasattr(new, "shape") and hasattr(old, "shape") \
                        and new.shape == old.shape \
                        and new.dtype == old.dtype:
                    return old
                return new
            self._state = merge(self._state, old_state)
            self._t = old_t

    def set_materials(self, geometry=None, default_material=None):
        """Swap the geometry / default material, keeping the fields
        (simulation.py set_materials; callable from step functions)."""
        if geometry is not None:
            self.geometry = list(geometry)
        if default_material is not None:
            self.default_material = default_material
        if self._plan is not None:
            self._rebuild_preserving_fields()

    def set_epsilon(self, eps):
        """Replace epsilon everywhere from a raw array spanning the cell
        (structure::set_epsilon role)."""
        self._eps_override = np.asarray(eps, np.float64)
        if self._plan is not None:
            self._rebuild_preserving_fields()

    def phase_in_material(self, structure, time, nstages: int = 16):
        """Linearly morph the current material coefficients into another
        Simulation's over `time` (fields::phase_in_material,
        structure::mix_with).  Compiled-loop adaptation: the interpolation is
        piecewise-constant over `nstages` sub-blocks instead of per step
        (coefficients are jit ARGUMENTS, so each stage costs no
        recompile)."""
        other = structure if isinstance(structure, Simulation) else None
        if other is None:
            raise TypeError("phase_in_material takes the other Simulation")
        self.init_sim()
        other.init_sim()
        import jax.numpy as jnp
        old = {k: v for k, v in self._plan.coefs.items()}
        new = other._plan.coefs
        keys = [k for k in old
                if k in new and getattr(old[k], "shape", None)
                == getattr(new[k], "shape", None)
                and np.issubdtype(np.asarray(old[k]).dtype, np.floating)]
        steps_total = max(1, int(round(time / self.dt)))
        nstages = max(1, min(nstages, steps_total))
        done = 0
        for s in range(nstages):
            target = (s + 1) * steps_total // nstages
            frac = (s + 0.5) / nstages
            self._plan.coefs = {
                k: ((1 - frac) * old[k] + frac * jnp.asarray(new[k])
                    if k in keys else v)
                for k, v in old.items()}
            if target > done:
                self.step(target - done)
                done = target
        self._plan.coefs = {k: (jnp.asarray(new[k]) if k in keys else v)
                            for k, v in old.items()}

    def add_sources(self):
        """(Re)inject Simulation.sources into the run plan
        (simulation.py add_sources)."""
        if self._plan is None:
            self.init_sim()
        else:
            self._rebuild_preserving_fields()

    def change_sources(self, new_sources):
        """Replace the source list, keeping the fields (simulation.py
        change_sources)."""
        self.sources = list(new_sources)
        if self._plan is not None:
            self._rebuild_preserving_fields()

    def change_k_point(self, k):
        """Change the Bloch k vector (simulation.py change_k_point);
        fields restart (the field storage layout may change)."""
        self.k_point = k
        if self._plan is not None:
            self._uninitialize()

    def change_m(self, m):
        """Change the cylindrical azimuthal number (simulation.py
        change_m); fields restart."""
        self.m = m
        if self._plan is not None:
            self._uninitialize()

    def restart_fields(self):
        """Zero the fields and the clock, keeping DFT accumulators
        (simulation.py restart_fields)."""
        if self._state is None:
            self.init_sim()
            return
        import jax.numpy as jnp

        def zero(tree):
            if isinstance(tree, dict):
                return {k: zero(v) for k, v in tree.items()}
            if hasattr(tree, "shape"):
                return jnp.zeros_like(tree)
            return tree
        self._state = {k: (v if k in ("dft", "rng") else zero(v))
                       for k, v in self._state.items()}
        self._t = 0

    def reset_meep(self):
        """Forget fields, structure, and monitors (simulation.py
        reset_meep)."""
        self._uninitialize()
        self._dft_specs = []
        self._handles = []

    def clear_dft_monitors(self):
        """Drop every DFT monitor (simulation.py clear_dft_monitors);
        fields are preserved."""
        old_state, old_t = self._state, self._t
        self._dft_specs = []
        self._handles = []
        if old_state is not None:
            self._uninitialize()
            self.init_sim()

            def merge(new, old):
                if isinstance(new, dict) and isinstance(old, dict):
                    return {k: (merge(new[k], old[k]) if k in old else new[k])
                            for k in new}
                if hasattr(new, "shape") and hasattr(old, "shape") \
                        and new.shape == old.shape:
                    return old
                return new
            self._state = {k: (v if k == "dft"
                               else merge(v, old_state.get(k, v)))
                           for k, v in self._state.items()}
            self._t = old_t

    # -- k-point band sweeps -------------------------------------------------
    def run_k_point(self, t: float = None, k=None):
        """One Bloch run: restart fields at k, Harminv at the first
        source's point/component over the union of source bandwidths
        (simulation.py run_k_point)."""
        from ..analysis.harminv import Harminv as _Hv
        if not self.sources:
            raise ValueError("run_k_point needs at least one source")
        lo, hi = [], []
        for s in self.sources:
            f0 = getattr(s.src, "frequency", None)
            w = getattr(s.src, "fwidth", None)
            if f0 is None or w is None:
                continue
            lo.append(f0 - w / 2)
            hi.append(f0 + w / 2)
        fmin, fmax = min(lo), max(hi)
        self.change_k_point(k)
        self.restart_fields() if self._state is not None else None
        h = _Hv(self.sources[0].component, self.sources[0].center,
                0.5 * (fmin + fmax), fmax - fmin)
        self.run(after_sources(h), until_after_sources=t if t is not None
                 else 50.0)
        return h

    def run_k_points(self, t: float = None, k_points=None):
        """Harminv eigenfrequencies per Bloch k (simulation.py
        run_k_points): returns a list (per k) of complex frequencies and
        prints freqs:/freqs-im: CSV lines."""
        all_freqs = []
        k_index = 0
        for k in (k_points or []):
            k_index += 1
            h = self.run_k_point(t, k)
            freqs = [complex(m.freq, m.decay) for m in h.modes]
            print(f"freqs:, {k_index}, "
                  + ", ".join(f"{tuple(_v3(k))[i]}" for i in range(3))
                  + ", " + ", ".join(str(f.real) for f in freqs))
            print(f"freqs-im:, {k_index}, "
                  + ", ".join(f"{tuple(_v3(k))[i]}" for i in range(3))
                  + ", " + ", ".join(str(f.imag) for f in freqs))
            all_freqs.append(freqs)
        return all_freqs

    # -- point material queries ----------------------------------------------
    def _material_medium_at(self, pt):
        c3 = _v3(pt)
        pts = np.array([[c3.x, c3.y, c3.z]])
        idx = scene._material_at(pts, list(self.geometry),
                                 self.default_material)
        i = int(idx[0])
        if i == -1:
            return self.default_material
        mobj = self.geometry[i].material
        return mobj if isinstance(mobj, Medium) else self.default_material

    def get_epsilon_point(self, pt=None, frequency: float = 0.0):
        """Average permittivity eigenvalue at a point (simulation.py
        get_epsilon_point): frequency 0 samples the smoothed grid;
        frequency != 0 evaluates the material's dispersive tensor."""
        if frequency == 0.0:
            self.init_sim()
            from scipy.ndimage import map_coordinates
            eps = np.real(np.asarray(self.get_epsilon()))
            ax = _vec_to_axes(self.gv, pt if pt is not None else Vector3())
            coords = []
            for a in range(self.gv.ndim):
                cs = self.gv.comp_coords("ez" if "ez" in
                                         self._state["f"] else
                                         list(self._state["f"])[0], a)
                cs = cs[: eps.shape[a]]
                coords.append([np.interp(ax[a], cs, np.arange(len(cs)))])
            return float(map_coordinates(eps, coords, order=1,
                                         mode="nearest")[0])
        med = self._material_medium_at(pt)
        t = np.asarray(med.epsilon(frequency))
        return complex(np.trace(t.reshape(3, 3)) / 3) if t.size == 9 \
            else complex(np.mean(t))

    def get_mu_point(self, pt=None, frequency: float = 0.0):
        """Average permeability eigenvalue at a point (simulation.py
        get_mu_point)."""
        med = self._material_medium_at(pt)
        t = np.asarray(med.mu(frequency) if frequency != 0.0
                       else (np.eye(3) if med.mu_diag is None
                             else np.diag(tuple(_v3(med.mu_diag)))))
        return complex(np.trace(t.reshape(3, 3)) / 3) if t.size == 9 \
            else complex(np.mean(t))

    # -- monitors / data ------------------------------------------------------
    def add_mode_monitor(self, *args, **kwargs):
        """add_flux for use with get_eigenmode_coefficients
        (simulation.py:add_mode_monitor)."""
        kwargs.pop("yee_grid", None)
        return self.add_flux(*args, **kwargs)

    def get_dft_data(self, handle):
        """All of a monitor's DFT accumulators, flattened complex
        (simulation.py get_dft_data)."""
        self.init_sim()
        out = []
        for key in sorted(self._state["dft"]):
            if key.startswith(handle.name + ":"):
                out.append(_dview(self._state["dft"][key]).ravel())
        return np.concatenate(out) if out else np.zeros(0, np.complex128)

    def output_dft(self, dft_fields, fname: str):
        """Write a dft_fields monitor to <fname>.h5 with <comp>_<n>.r/.i
        datasets (simulation.py output_dft)."""
        self.init_sim()
        import h5py
        path = fname if fname.endswith(".h5") else fname + ".h5"
        with h5py.File(path, "w") as h5:
            for c in dft_fields.components:
                arr = np.asarray(self.get_dft_array(dft_fields, c))
                for fi in range(arr.shape[-1]):
                    h5.create_dataset(f"{c}_{fi}.r",
                                      data=np.real(arr[..., fi]))
                    h5.create_dataset(f"{c}_{fi}.i",
                                      data=np.imag(arr[..., fi]))
        return path

    def save_energy(self, fname, energy):
        """save_flux for an energy monitor (simulation.py save_energy)."""
        self.save_flux(fname, energy)

    def load_energy(self, fname, energy):
        self.load_flux(fname, energy)

    def load_minus_energy(self, fname, energy):
        self.load_minus_flux(fname, energy)

    def load_near2far_data(self, near2far, n2fdata):
        self.load_flux_data(near2far, n2fdata)

    def load_force_data(self, force, fdata):
        self.load_flux_data(force, fdata)

    def display_fluxes(self, *fluxes):
        """CSV table of frequencies + flux spectra (simulation.py
        display_fluxes)."""
        from .run_control import display_csv
        display_csv(self, "flux", zip(get_flux_freqs(fluxes[0]),
                                      *[get_fluxes(f) for f in fluxes]))

    def display_forces(self, *forces):
        from .run_control import display_csv
        display_csv(self, "force", zip(get_force_freqs(forces[0]),
                                       *[self.get_forces(f)
                                         for f in forces]))

    def display_electric_energy(self, *energys):
        from .run_control import display_csv
        display_csv(self, "electric_energy",
                    zip(get_energy_freqs(energys[0]),
                        *[self.get_electric_energy(e) for e in energys]))

    def display_magnetic_energy(self, *energys):
        from .run_control import display_csv
        display_csv(self, "magnetic_energy",
                    zip(get_energy_freqs(energys[0]),
                        *[self.get_magnetic_energy(e) for e in energys]))

    def display_total_energy(self, *energys):
        from .run_control import display_csv
        display_csv(self, "total_energy",
                    zip(get_energy_freqs(energys[0]),
                        *[self.get_total_energy(e) for e in energys]))

    def output_farfields(self, near2far, fname=None, resolution=None,
                         where=None, center=None, size=None):
        """Far fields on a `resolution` grid over a (possibly
        outside-the-cell) volume, written as ex.r/ex.i/... datasets
        (simulation.py output_farfields)."""
        if where is not None:
            center, size = get_center_and_size(where)
        arr = self.get_farfields(near2far, resolution, center=center,
                                 size=size)      # (6, nfreq) + grid
        comps = ("ex", "ey", "ez", "hx", "hy", "hz")
        data = {}
        for ci, c in enumerate(comps):
            a = np.moveaxis(arr[ci], 0, -1)      # grid + (nfreq,)
            data[c + ".r"] = np.real(a)
            data[c + ".i"] = np.imag(a)
        if fname is None:
            return data
        import h5py
        path = fname if fname.endswith(".h5") else fname + ".h5"
        with h5py.File(path, "w") as h5:
            for k, v in data.items():
                h5.create_dataset(k, data=v)
        return path

    def modal_volume_in_box(self, box=None, center=None, size=None):
        """Purcell modal volume int(eps |E|^2) / max(eps |E|^2)
        (simulation.py modal_volume_in_box)."""
        self.init_sim()
        if box is not None:
            center, size = get_center_and_size(box)
        eps = np.real(np.asarray(self.get_epsilon()))
        u = None
        for c in ("ex", "ey", "ez", "er", "ep"):
            if c not in self._state["f"]:
                continue
            arr = np.abs(np.asarray(self.get_array(
                component=c, center=center, size=size))) ** 2
            if u is None:
                u = np.zeros(np.minimum(arr.shape, eps.shape))
            sl = tuple(slice(0, n) for n in u.shape)
            u = u + arr[sl]
        if center is None and size is None:
            sl = tuple(slice(0, n) for n in u.shape)
            u = u * eps[sl]
        dv = self.gv.dx ** self.gv.ndim
        return float(u.sum() * dv / max(u.max(), 1e-300))

    # -- field functions ------------------------------------------------------
    def _field_function_grid(self, cs, fields2=None, cs2=()):
        """(pts, value arrays) on the common centered lattice for field
        functions (integrate.cpp role)."""
        arrs = [np.asarray(self.get_array(component=c)) for c in cs]
        arrs += [np.asarray(fields2.get_array(component=c)) for c in cs2]
        shp = tuple(min(a.shape[i] for a in arrs)
                    for i in range(arrs[0].ndim))
        arrs = [a[tuple(slice(0, n) for n in shp)] for a in arrs]
        coords = [self.gv.comp_coords(cs[0], a)[: shp[a]]
                  for a in range(self.gv.ndim)]
        return coords, arrs

    def max_abs_field_function(self, cs, func, where=None, center=None,
                               size=None):
        """max |func(r, fields...)| over the grid (simulation.py
        max_abs_field_function)."""
        coords, arrs = self._field_function_grid(cs)
        best = 0.0
        for ind in np.ndindex(*arrs[0].shape):
            pt = [coords[a][ind[a]] for a in range(len(coords))]
            v3 = Vector3(*(pt + [0.0] * (3 - len(pt))))
            best = max(best, abs(func(v3, *[a[ind] for a in arrs])))
        return best

    def integrate2_field_function(self, fields2, cs1, cs2, func,
                                  where=None, center=None, size=None):
        """Two-simulation field-function integral (simulation.py
        integrate2_field_function / integrate2.cpp)."""
        coords, arrs = self._field_function_grid(cs1, fields2, cs2)
        dv = self.gv.dx ** self.gv.ndim
        total = 0.0
        for ind in np.ndindex(*arrs[0].shape):
            pt = [coords[a][ind[a]] for a in range(len(coords))]
            v3 = Vector3(*(pt + [0.0] * (3 - len(pt))))
            total += func(v3, *[a[ind] for a in arrs])
        return total * dv

    def output_field_function(self, name, cs, func, real_only=False,
                              h5file=None):
        """Evaluate func over the grid and save it under `name`
        (simulation.py output_field_function)."""
        coords, arrs = self._field_function_grid(cs)
        out = np.zeros(arrs[0].shape, complex)
        for ind in np.ndindex(*arrs[0].shape):
            pt = [coords[a][ind[a]] for a in range(len(coords))]
            v3 = Vector3(*(pt + [0.0] * (3 - len(pt))))
            out[ind] = func(v3, *[a[ind] for a in arrs])
        from .run_control import _save
        if real_only:
            _save(self, name, np.real(out))
        else:
            _save(self, name + ".r", np.real(out))
            _save(self, name + ".i", np.imag(out))

    def output_component(self, c, h5file=None, frequency=0):
        """Save one component over the cell (simulation.py
        output_component)."""
        from .run_control import _save
        arr = self.get_epsilon() if c == Dielectric else \
            self.get_array(component=c)
        _save(self, c if isinstance(c, str) else str(c), arr)

    def output_components(self, fname, *components):
        """Save several components into one .npz (simulation.py
        output_components)."""
        data = {}
        for c in components:
            data[c] = np.asarray(self.get_epsilon() if c == Dielectric
                                 else self.get_array(component=c))
        np.savez(fname if fname.endswith(".npz") else fname + ".npz",
                 **data)

    def h5topng(self, rm_h5, option, *step_funcs):
        """convert_h5 preconfigured for h5topng (simulation.py
        h5topng)."""
        from .run_control import convert_h5
        return convert_h5(rm_h5, f"h5topng {option}", *step_funcs)

    def get_source(self, component, vol=None, center=None, size=None):
        """Spatial source amplitude array for `component` at the current
        time, on the component lattice (simulation.py get_source)."""
        self.init_sim()
        shape = tuple(n + 1 for n in self.gv.num)
        out = np.zeros(shape, np.complex128)
        t = self.meep_time()
        for s in self._plan.sources:
            if s.component != component:
                continue
            cur = s.src_time.current(t, self.dt)
            idx = np.asarray(s.indices)
            amps = np.asarray(s.amps)
            for k in range(len(idx)):
                ind = tuple(int(i) for i in idx[k])
                if all(i < n for i, n in zip(ind, shape)):
                    out[ind] += amps[k] * cur
        return out

    def get_array_slice_dimensions(self, component, vol=None, center=None,
                                   size=None):
        """(dims, min_corner, max_corner) of a get_array slice
        (simulation.py get_array_slice_dimensions)."""
        if vol is not None:
            center, size = get_center_and_size(vol)
        coords, _ = self.get_array_metadata(component=component,
                                            center=center, size=size)
        dims = [len(c) for c in coords]
        lo = [float(c[0]) for c in coords]
        hi = [float(c[-1]) for c in coords]
        pad = [0.0] * (3 - len(lo))
        return dims, Vector3(*(lo + pad)), Vector3(*(hi + pad))

    # -- timing ---------------------------------------------------------------
    _TIME_SINKS = {0: "stepping", 1: "connecting chunks",
                   2: "copying boundaries", 3: "all-all communication",
                   4: "1-1 communication", 5: "outputting fields",
                   6: "fourier transforming", 7: "mpb mode solver",
                   8: "near-to-far-field transform", 21: "everything else"}

    def mean_time_spent_on(self, time_sink):
        """Mean (single process: the) wall time for a work category;
        accepts the reference's integer time-sink codes or this
        framework's category strings (simulation.py
        mean_time_spent_on)."""
        if isinstance(time_sink, int):
            time_sink = self._TIME_SINKS.get(time_sink, "")
        return self.timers.time_spent_on(time_sink)

    def get_timing_data(self):
        """category -> [seconds per process] (simulation.py
        get_timing_data)."""
        return {k: [v] for k, v in self.timers.summary().items()}

    def output_times(self, fname):
        """CSV of the timing table (simulation.py output_times)."""
        if not fname.endswith(".csv"):
            fname += ".csv"
        data = self.timers.summary()
        with open(fname, "w") as f:
            f.write(",".join(data.keys()) + "\n")
            f.write(",".join(f"{v:.6f}" for v in data.values()) + "\n")
        return fname

    # -- stacked field getters -------------------------------------------------
    def _get_field_family(self, letter, snap=False):
        if self.dim == "cyl":
            comps = (letter + "r", letter + "p")
        else:
            comps = (letter + "x", letter + "y", letter + "z")
        arrs = []
        for c in comps:
            try:
                arrs.append(np.asarray(self.get_array(component=c,
                                                      snap=snap)))
            except KeyError:
                arrs.append(None)
        shp = tuple(min(a.shape[i] for a in arrs if a is not None)
                    for i in range(next(a.ndim for a in arrs
                                        if a is not None)))
        arrs = [np.zeros(shp) if a is None
                else a[tuple(slice(0, n) for n in shp)] for a in arrs]
        return np.stack(arrs, axis=-1)

    def get_efield(self, snap=False):
        """All E components stacked on the last axis (simulation.py
        get_efield)."""
        return self._get_field_family("e", snap)

    def get_hfield(self, snap=False):
        return self._get_field_family("h", snap)

    def get_dfield(self, snap=False):
        return self._get_field_family("d", snap)

    def get_bfield(self, snap=False):
        # B == H storage unless mu materials introduce separate b arrays
        try:
            return self._get_field_family("b", snap)
        except StopIteration:
            return self._get_field_family("h", snap)

    def get_sfield(self, snap=False):
        """Poynting E x H with synchronized magnetic fields
        (simulation.py get_sfield)."""
        self._hb_override = self._synchronized_hb()
        try:
            E = self.get_efield(snap)
            H = self.get_hfield(snap)
        finally:
            self._hb_override = None
        return np.cross(np.conj(E), H)

    def get_hpwr(self, snap=False):
        """Magnetic energy density grid (simulation.py get_hpwr)."""
        from .run_control import _energy_density
        return _energy_density(self, "h")

    def get_dpwr(self, snap=False):
        from .run_control import _energy_density
        return _energy_density(self, "e")

    def get_tot_pwr(self, snap=False):
        from .run_control import _energy_density
        return _energy_density(self, "e") + _energy_density(self, "h")

    # -- plotting wrappers -------------------------------------------------------
    def plot2D(self, **kwargs):
        """utils.visualization.plot2D bound as a method (simulation.py
        plot2D)."""
        from ..utils.visualization import plot2D as _p
        return _p(self, **kwargs)

    def plot_fields(self, **kwargs):
        from ..utils.visualization import plot_fields as _p
        return _p(self, **kwargs)

    def plot3D(self, **kwargs):
        from ..utils.visualization import plot3D as _p
        return _p(self, **kwargs)

    def visualize_chunks(self):
        """Show the uniform shard decomposition over the device mesh
        (simulation.py visualize_chunks)."""
        import jax
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = max(jax.device_count(), 1)
        fig, ax = plt.subplots()
        sx = self.gv.num[0]
        sy = self.gv.num[1] if self.gv.ndim > 1 else 1
        for i in range(n):
            x0 = i * sx / n
            ax.add_patch(plt.Rectangle((x0, 0), sx / n, sy,
                                       facecolor=plt.cm.tab20(i % 20),
                                       edgecolor="k"))
            ax.text(x0 + sx / (2 * n), sy / 2, str(i), ha="center")
        ax.set_xlim(0, sx)
        ax.set_ylim(0, sy)
        ax.set_title(f"{n} uniform shards")
        return fig

    # -- dump/load split (structure vs fields) -----------------------------------
    def get_load_dump_dirname(self, dirname=None,
                              single_parallel_file=None):
        """Dump dirname, rank-suffixed for sharded dumps (simulation.py
        get_load_dump_dirname)."""
        if single_parallel_file:
            return dirname
        return os.path.join(dirname, "rank00")

    def dump_structure(self, fname: str = None,
                       single_parallel_file: bool = True):
        """Save the static material/PML coefficient arrays
        (structure_dump.cpp:89 role)."""
        self.init_sim()
        np.savez(fname if fname.endswith(".npz") else fname + ".npz",
                 **{k: np.asarray(v) for k, v in self._plan.coefs.items()})

    def load_structure(self, fname: str = None,
                       single_parallel_file: bool = True):
        """Load coefficient arrays saved by dump_structure (shapes must
        match the current layout, as the reference requires)."""
        import jax.numpy as jnp
        self.init_sim()
        path = fname if fname.endswith(".npz") else fname + ".npz"
        with np.load(path) as z:
            coefs = dict(self._plan.coefs)
            for k in z.files:
                if k in coefs and z[k].shape != np.shape(coefs[k]):
                    raise ValueError(
                        f"structure file {k} shape {z[k].shape} != "
                        f"{np.shape(coefs[k])} (same-layout rule)")
                coefs[k] = jnp.asarray(z[k])
            self._plan.coefs = coefs

    def dump_fields(self, fname: str = None,
                    single_parallel_file: bool = True):
        """Checkpoint the field state (fields_dump.cpp role)."""
        self.dump(fname)

    def load_fields(self, fname: str = None,
                    single_parallel_file: bool = True):
        self.load(fname)

    def dump_chunk_layout(self, fname: str = None):
        """Record the (uniform) shard layout (structure_dump.cpp
        dump_chunk_layout)."""
        import jax
        import json
        with open(fname, "w") as f:
            json.dump({"n_shards": max(jax.device_count(), 1),
                       "grid": [int(n) for n in self.gv.num]}, f)

    def load_chunk_layout(self, br=None, source=None):
        """Verify a layout saved by dump_chunk_layout matches this run
        (load requires the same chunk layout, meep.hpp:880)."""
        import jax
        import json
        if isinstance(source, Simulation):
            return
        with open(source if source is not None else br) as f:
            info = json.load(f)
        if info["grid"] != [int(n) for n in self.gv.num] or \
                info["n_shards"] != max(jax.device_count(), 1):
            raise ValueError("chunk layout mismatch: saved "
                             f"{info} vs current grid "
                             f"{[int(n) for n in self.gv.num]}")

    # ---------------------------------------------------------- checkpoint
    def dump(self, path: str):
        """Checkpoint fields+monitors+time (fields_dump.cpp:108 analog)."""
        from ..io import checkpoint as CK
        self.init_sim()
        CK.save_state(path, self._plan, self._state, t=self._t)

    def load(self, path: str):
        """Resume from a checkpoint produced by an identically-configured
        Simulation (structure/fields load, simulation.py:2293-2448)."""
        from ..io import checkpoint as CK
        self.init_sim()
        self._state = CK.load_state(path, self._plan)
        self._t = CK.load_t(path)


def _install_component_getters():
    """get_{e,h,d,b}field_{x,y,z,r,p} and get_sfield_* methods
    (simulation.py:5596-5956 family): thin get_array / Poynting
    wrappers, generated once."""
    def field_getter(comp):
        def g(self, snap=False):
            return self.get_array(component=comp, snap=snap)
        g.__name__ = f"get_{comp[0]}field_{comp[1]}"
        g.__doc__ = (f"Array of {comp} over the cell (simulation.py "
                     f"get_{comp[0]}field_{comp[1]})." )
        return g

    def sfield_getter(d):
        cyc = {"x": ("y", "z"), "y": ("z", "x"), "z": ("x", "y"),
               "r": ("p", "z"), "p": ("z", "r")}

        def g(self, snap=False):
            p, q = cyc[d]
            self._hb_override = self._synchronized_hb()
            try:
                def get(c):
                    try:
                        return np.asarray(self.get_array(component=c,
                                                         snap=snap))
                    except KeyError:
                        return None
                ep_, eq_ = get("e" + p), get("e" + q)
                hp_, hq_ = get("h" + p), get("h" + q)
            finally:
                self._hb_override = None
            arrs = [a for a in (ep_, eq_, hp_, hq_) if a is not None]
            if not arrs:
                raise KeyError(f"no in-plane components for S{d}")
            shp = tuple(min(a.shape[i] for a in arrs)
                        for i in range(arrs[0].ndim))

            def crop(a):
                return np.zeros(shp) if a is None else \
                    a[tuple(slice(0, n) for n in shp)]
            return (np.conj(crop(ep_)) * crop(hq_)
                    - np.conj(crop(eq_)) * crop(hp_))
        g.__name__ = f"get_sfield_{d}"
        g.__doc__ = (f"Poynting S{d} = (E x H*){d} with synchronized "
                     f"magnetic fields (simulation.py get_sfield_{d}).")
        return g

    for fam in "ehdb":
        for d in "xyzrp":
            comp = ("h" if fam == "b" else fam) + d
            setattr(Simulation, f"get_{fam}field_{d}", field_getter(comp))
    for d in "xyzrp":
        setattr(Simulation, f"get_sfield_{d}", sfield_getter(d))


_install_component_getters()


def _volume_sites(gv: G.GridVolume, comp: str, center, size):
    """Component-site slices + integration weights over a volume (the source
    counterpart of the monitor weight scheme, sources.cpp:243)."""
    slices = []
    ws = []
    for ax in range(gv.ndim):
        coords = gv.comp_coords(comp, ax)
        lo = center[ax] - size[ax] / 2
        hi = center[ax] + size[ax] / 2
        # reuse the monitor weight engine on the component lattice
        c0 = coords[0]
        fa = (lo - c0) / gv.dx
        fb = (hi - c0) / gv.dx
        start, stop, w = M._axis_weights_lattice(fa, fb, len(coords))
        slices.append(slice(start, stop))
        ws.append(w)
    w_full = ws[0]
    for w in ws[1:]:
        w_full = np.multiply.outer(w_full, w)
    return slices, w_full


def _site_coord(gv: G.GridVolume, comp: str, idx) -> Vector3:
    vals = [gv.comp_coords(comp, ax)[idx[ax]] for ax in range(gv.ndim)]
    slot = {"x": 0, "y": 1, "z": 2, "r": 0, "p": 1}
    v = [0.0, 0.0, 0.0]
    for ax, d in enumerate(gv.axes):
        v[slot[d]] = vals[ax]
    if gv.dim == "1d":
        v = [0.0, 0.0, vals[0]]
    return Vector3(*v)


def after_sources(*step_funcs):
    """Marker: apply these step functions only once sources have turned off
    (simulation.py:5059 after_sources)."""
    return ("after_sources", step_funcs)


def _apply_absorbers(gv, mat, absorbers, live_e, live_h):
    """Scalar-conductivity absorber layers (the reference's Absorber
    fallback: a quadratic D+B conductivity ramp instead of uPML; used where
    PML fails, e.g. backed by dispersive media)."""
    for d, bl in absorbers:
        ax = gv.axis_of(d)
        lo = gv.origin[ax]
        hi = lo + gv.size[ax]
        sides = [-1, +1] if bl.side == 0 else [bl.side]
        # strength calibrated like PML: -ln(R)/(2 * thickness * mean)
        strength = -np.log(bl.r_asymptotic) / (2.0 * bl.thickness) / 2.0
        for c in list(live_e) + list(live_h):
            key = ("d" if c[0] == "e" else "b") + c[1]
            coords = gv.comp_coords(key, ax)
            prof = np.zeros(len(coords))
            for side in sides:
                edge = lo if side < 0 else hi
                depth = np.maximum(0.0, bl.thickness - np.abs(coords - edge))
                u = depth / bl.thickness
                prof = np.maximum(prof, strength * u ** bl.pml_profile_power)
            shape = [1] * gv.ndim
            shape[ax] = -1
            arr = np.broadcast_to(prof.reshape(shape), gv.shape).copy()
            if key in mat.cond and mat.cond[key] is not None:
                mat.cond[key] = mat.cond[key] + arr
            else:
                mat.cond[key] = arr


# ---------------------------------------------------------------------------
# module-level monitor accessors (python/simulation.py exposes these as free
# functions operating on the dft objects; handles carry a ._sim backref)
# ---------------------------------------------------------------------------


def _handle_sim(handle):
    sim = getattr(handle, "_sim", None)
    if sim is None:
        raise ValueError("monitor handle is not attached to a Simulation")
    return sim


def get_fluxes(flux) -> np.ndarray:
    return _handle_sim(flux).get_fluxes(flux)


def get_flux_freqs(flux):
    return list(np.asarray(flux.freqs))


def get_forces(force) -> np.ndarray:
    return _handle_sim(force).get_forces(force)


def get_force_freqs(force):
    return list(np.asarray(force.freqs))


def get_energy_freqs(en):
    return list(np.asarray(en.freqs))


def get_electric_energy(en) -> np.ndarray:
    return _handle_sim(en).get_electric_energy(en)


def get_magnetic_energy(en) -> np.ndarray:
    return _handle_sim(en).get_magnetic_energy(en)


def get_total_energy(en) -> np.ndarray:
    return _handle_sim(en).get_total_energy(en)


def get_ldos_freqs(ldos):
    return list(np.asarray(ldos.freqs))


def get_near2far_freqs(n2f):
    return list(np.asarray(n2f.freqs))


def get_eigenmode_freqs(flux):
    return list(np.asarray(flux.freqs))


def quiet(quietval: bool = True):
    """Verbosity shim (python/simulation.py quiet)."""
    import meep_nl_tpu as _m
    _m.verbosity.set(0 if quietval else 1)


# dft-object class names (python/simulation.py DftFlux/DftForce/...):
# the reference returns typed wrapper objects from add_flux et al.; here
# the same roles are played by the handle classes
DftObj = object
DftFlux = _FluxHandle
DftNear2Far = _N2FHandle
DftFields = _DftFieldsHandle
DftEnergy = _FluxHandle
DftForce = _FluxHandle
Ldos = _FluxHandle
dft_ldos = _FluxHandle


def scale_flux_fields(s, flux):
    """Scale the Fourier-transformed fields of a monitor by the complex
    number s (python/simulation.py scale_flux_fields; load_minus_flux ==
    load_flux + scale by -1).  Accumulators are (..., nfreq, 2) re/im
    stacks, so complex s is a 2x2 rotation on the last axis."""
    sim = _handle_sim(flux)
    sim.init_sim()
    s = complex(s)
    dft = dict(sim._state["dft"])
    for key in list(dft):
        if key.startswith(flux.name + ":"):
            re = dft[key][..., 0]
            im = dft[key][..., 1]
            dft[key] = jnp.stack([s.real * re - s.imag * im,
                                  s.real * im + s.imag * re], axis=-1)
    sim._state = {**sim._state, "dft": dft}


def scale_force_fields(s, force):
    """scale_flux_fields for a force monitor (simulation.py:6030)."""
    scale_flux_fields(s, force)


def scale_energy_fields(s, ef):
    """scale_flux_fields for an energy monitor (simulation.py:6075)."""
    scale_flux_fields(s, ef)


def scale_near2far_fields(s, near2far):
    """scale_flux_fields for a near2far monitor (simulation.py:6058)."""
    scale_flux_fields(s, near2far)


def bands_to_diffractedplanewave(where, bands):
    """Normalize a DiffractedPlanewave band spec against its monitor
    region (python/simulation.py bands_to_diffractedplanewave): fills
    the default axis (the region's first in-plane direction) and checks
    it is nonzero."""
    axis = bands.axis
    if axis is None:
        sz = tuple(_v3(where.size if hasattr(where, "size") else Vector3()))
        for i, d in enumerate("xyz"):
            if sz[i] != 0:
                axis = Vector3(*(1.0 if j == i else 0.0 for j in range(3)))
                break
        if axis is None:
            raise ValueError(
                "axis parameter of DiffractedPlanewave must be a "
                "non-zero Vector3")
    a = np.asarray(tuple(_v3(axis)), float)
    if np.linalg.norm(a) == 0:
        raise ValueError(
            "axis parameter of DiffractedPlanewave must be a non-zero "
            "Vector3")
    return dataclasses.replace(bands, axis=Vector3(*(a / np.linalg.norm(a))))


def complexarray(re, im):
    """re + 1j*im elementwise (python/simulation.py complexarray)."""
    return np.asarray(re) + 1j * np.asarray(im)


def find_root_deriv(f, tol, x_min, x_max, x_guess=None):
    """Newton's method with bisection fallback for f returning
    (value, derivative) (libctl find-root-deriv semantics)."""
    lo, hi = float(x_min), float(x_max)
    x = float(x_guess) if x_guess is not None else 0.5 * (lo + hi)
    for _ in range(200):
        val, dv = f(x)
        if abs(val) < tol:
            return x
        if val > 0:
            hi = min(hi, x)
        else:
            lo = max(lo, x)
        x_new = x - val / dv if dv != 0 else 0.5 * (lo + hi)
        if not (lo < x_new < hi):
            x_new = 0.5 * (lo + hi)
        x = x_new
    return x


# ---- process groups (single-controller JAX: the mesh plays MPI's role;
# parallel/groups.py runs real device-group sweeps) --------------------------

_n_groups = 1


def divide_parallel_processes(n: int) -> int:
    """Declare n independent simulation groups (divide_parallel_processes).
    Under the single-controller JAX runtime every group runs in this
    process (use parallel.groups.run_parameter_sweep for real
    device-group parallelism); returns this controller's group index."""
    global _n_groups
    _n_groups = int(n)
    return 0


def get_num_groups() -> int:
    return _n_groups


def get_group_masters():
    """Rank of each group's master (all 0 under one controller)."""
    return [0] * _n_groups


def am_master() -> bool:
    return True


def am_really_master() -> bool:
    return True


def count_processors() -> int:
    import jax
    return max(1, jax.device_count())
