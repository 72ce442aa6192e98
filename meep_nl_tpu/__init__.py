"""meep_nl_tpu: an FDTD electromagnetics framework in JAX.

Brand-new JAX/XLA implementation of the capabilities of the meep_nl fork of
Meep (reference layer map in SURVEY.md): full-vector Maxwell time-stepping on
the staggered Yee grid, uPML, dispersive and nonlinear (chi2 Pockels via
Newton inversion, chi3 Kerr) media, in-loop DTFT monitors, and native
jax.grad adjoints, sharded over device meshes by GSPMD.
"""

from .core import grid
from .core.grid import GridVolume
from .stepper import plan as stepplan
from .stepper.plan import (MaterialSpec, PolSpec, PMLSpec, SrcVolSpec,
                           DftSpec, compile_plan)
from .stepper.step import init_state, make_step, build_xs, run
from .models.source import (GaussianSource, ContinuousSource, CustomSource,
                            Source, SourceTime, GaussianBeamSource,
                            GaussianBeam2DSource, GaussianBeam3DSource,
                            EigenModeSource, IndexedSource,
                            check_positive, get_equiv_sources)
from .models.geom import (Vector3, Medium, Sphere, Block, Cylinder, Cone,
                          Wedge, Ellipsoid, Prism, GeometricObject,
                          check_nonnegative, init_do_averaging, memoize,
                          LorentzianSusceptibility,
                          DrudeSusceptibility, NoisyLorentzianSusceptibility,
                          NoisyDrudeSusceptibility,
                          GyrotropicLorentzianSusceptibility,
                          GyrotropicDrudeSusceptibility,
                          GyrotropicSaturatedSusceptibility,
                          Susceptibility, Transition,
                          MultilevelAtom, vacuum, air,
                          Volume, Matrix, Lattice, get_rotation_matrix,
                          get_center_and_size, interpolate,
                          lattice_to_cartesian, cartesian_to_lattice,
                          lattice_to_reciprocal, reciprocal_to_lattice,
                          reciprocal_to_cartesian, cartesian_to_reciprocal)
from .models.simulation import (Simulation, PML, Absorber, FluxRegion,
                                Near2FarRegion, ForceRegion, EnergyRegion,
                                FieldsRegion, fix_dft_args, get_num_args,
                                vec, py_v3_to_vec,
                                scale_force_fields, scale_energy_fields,
                                scale_near2far_fields, dft_ldos,
                                after_sources,
                                Ex, Ey, Ez, Hx, Hy, Hz, Dx, Dy, Dz,
                                Bx, By, Bz, Er, Ep, Hr, Hp, Dielectric,
                                Dr, Dp, Br, Bp, Permeability,
                                Sx, Sy, Sz, Sr, Sp, EnergyDensity,
                                D_EnergyDensity, H_EnergyDensity,
                                X, Y, Z, R, ALL,
                                Low, High, Metallic, Magnetic, Mirror, Rotate2, Rotate4,
                                Symmetry, Identity, BinaryPartition,
                                DiffractedPlanewave,
                                get_fluxes, get_flux_freqs, get_forces,
                                get_force_freqs, get_energy_freqs,
                                get_electric_energy, get_magnetic_energy,
                                get_total_energy, get_ldos_freqs,
                                get_near2far_freqs, get_eigenmode_freqs,
                                quiet, DftObj, DftFlux, DftForce, DftEnergy,
                                DftFields, DftNear2Far, Ldos,
                                scale_flux_fields,
                                bands_to_diffractedplanewave, complexarray,
                                find_root_deriv, divide_parallel_processes,
                                get_num_groups, get_group_masters,
                                am_master, am_really_master,
                                count_processors)
from .analysis.harminv import Harminv, harminv
from .analysis.pade import PadeDFT
from .parallel.groups import merge_subgroup_data
from .analysis.bands import ModeSolver, ModeSolver3D, retrieve_gap
from .analysis.mpb_data import MPBData
from .analysis.modes import Mode1D, Mode2D
EigenmodeData = Mode2D      # get_eigenmode's return type (3d full-vector)
from .models.geom import (geometric_object_duplicates,
                          geometric_objects_duplicates,
                          geometric_objects_lattice_duplicates)

inf = float("inf")

__version__ = "0.1.0"

from .models.run_control import (at_every, at_beginning, at_end,
                                 during_sources, in_volume, in_point,
                                 at_time, before_time, after_time,
                                 after_sources_and_time,
                                 when_true, when_false, combine_step_funcs,
                                 synchronized_magnetic,
                                 stop_when_fields_decayed,
                                 stop_when_dft_decayed,
                                 stop_when_energy_decayed,
                                 stop_after_walltime, stop_on_interrupt,
                                 output_field,
                                 output_efield, output_hfield,
                                 output_efield_x, output_efield_y,
                                 output_efield_z, output_efield_r,
                                 output_efield_p,
                                 output_hfield_x, output_hfield_y,
                                 output_hfield_z, output_hfield_r,
                                 output_hfield_p,
                                 output_dfield_x, output_dfield_y,
                                 output_dfield_z, output_dfield_r,
                                 output_dfield_p,
                                 output_bfield_x, output_bfield_y,
                                 output_bfield_z, output_bfield_r,
                                 output_bfield_p,
                                 output_poynting, output_poynting_x,
                                 output_poynting_y, output_poynting_z,
                                 output_poynting_r, output_poynting_p,
                                 output_sfield, output_sfield_x,
                                 output_sfield_y, output_sfield_z,
                                 output_sfield_r, output_sfield_p,
                                 output_dpwr, output_hpwr, output_tot_pwr,
                                 output_png, output_mu, output_epsilon,
                                 output_dfield, output_bfield,
                                 to_appended, with_prefix, convert_h5,
                                 display_progress, display_run_data,
                                 display_csv, data_to_str,
                                 FieldProbe)
from .io.gdsii import (get_GDSII_prisms, GDSII_prisms, GDSII_layers,
                       GDSII_vol)
from .adjoint.design import MaterialGrid
from .utils.visualization import plot2D, plot3D, plot_fields, Animate2D

CYLINDRICAL = "cyl"


class Verbosity:
    """Shared verbosity shim (python/verbosity_mgr.py Verbosity): levels
    0 = quiet .. 3 = debug; only gates this package's optional prints.
    The cvar/name constructor args of the reference (C-library verbosity
    globals) are accepted and recorded for API parity."""

    def __init__(self, cvar=None, name=None, initial_level=1):
        self.meep = int(initial_level)
        self.mpb = int(initial_level)
        if name:
            setattr(self, name, int(initial_level))

    def __call__(self, level=None):
        if level is not None:
            self.meep = int(level)
        return self.meep

    def set(self, level):
        self.meep = int(level)
        return self.meep


_Verbosity = Verbosity          # round-2 name, kept for callers
verbosity = Verbosity()

from . import mpb  # noqa: E402  (python/solver.py surface: mp.mpb.*)
