"""Symmetry folds under the GSPMD mesh: mirror/C2/C4-folded plans must be
invariant under re-sharding of the (folded) grid over the device mesh.

The reference composes symmetry with its MPI decomposition by giving every
chunk symmetry-transformed partners in the connection tables
(boundaries.cpp:280-302); here the fold ghosts are global-array reads in the
jnp stepper, so GSPMD inserts the cross-shard collectives (the flip/transpose
reads at the fold boundary become permute/gather collectives).  These gates
pin that composition: 8 x-shards vs single device at fp32 roundoff."""

import numpy as np
import jax

import meep_nl_tpu as mnt
from meep_nl_tpu.parallel import mesh as PM
from meep_nl_tpu.stepper.step import init_state, run


def _plan_of(sim):
    sim.run(until=0.25)
    return sim._plan


def _assert_invariant(plan, nsteps=60, atol_scale=5e-6):
    st_ref = run(plan, init_state(plan), nsteps)
    mesh = PM.make_mesh(8, shape=(8,))
    st_sh = PM.sharded_run(plan, mesh, init_state(plan), nsteps)
    scale = max(float(np.max(np.abs(np.asarray(v))))
                for v in st_ref["f"].values())
    assert scale > 0
    for c, ref in st_ref["f"].items():
        sh = np.asarray(jax.device_get(st_sh["f"][c]))
        np.testing.assert_allclose(sh, np.asarray(ref),
                                   atol=atol_scale * scale,
                                   err_msg=f"component {c}")


def _src3d(center=(0.9, -0.9, 0.3)):
    return [mnt.Source(mnt.GaussianSource(frequency=1.0, fwidth=0.5),
                       component=mnt.Ez, center=mnt.Vector3(*center))]


def test_rot2_3d_sharded():
    """C2 fold ghost (flip + parity across x=0) through the mesh."""
    sim = mnt.Simulation(cell_size=mnt.Vector3(8, 8, 8), resolution=4,
                         boundary_layers=[mnt.PML(1.0)], sources=_src3d(),
                         symmetries=[mnt.Rotate2("z")],
                         eps_averaging=False)
    _assert_invariant(_plan_of(sim))


def test_mirror_3d_sharded():
    """Mirror wall fold along y with the grid sharded along x."""
    sim = mnt.Simulation(cell_size=mnt.Vector3(8, 8, 8), resolution=4,
                         boundary_layers=[mnt.PML(1.0)], sources=_src3d(),
                         symmetries=[mnt.Mirror("y")],
                         eps_averaging=False)
    _assert_invariant(_plan_of(sim))


def test_mirror_x_3d_sharded():
    """Mirror fold along the SHARDED axis itself: the wall lands inside
    shard 0 and the retained half is re-sharded over all 8 devices."""
    src = [mnt.Source(mnt.GaussianSource(frequency=1.0, fwidth=0.5),
                      component=mnt.Ez, center=mnt.Vector3(0.0, 0.9, 0.3))]
    sim = mnt.Simulation(cell_size=mnt.Vector3(8, 8, 8), resolution=4,
                         boundary_layers=[mnt.PML(1.0)], sources=src,
                         symmetries=[mnt.Mirror("x")],
                         eps_averaging=False)
    _assert_invariant(_plan_of(sim))


def test_rot4_3d_sharded():
    """C4 quarter wedge: the ghost is a TRANSPOSED read of the x<->y
    swapped component — under x-sharding that transpose is an
    all-to-all-like collective.  Geometry chosen so the unpadded square
    wedge is divisible by the 8-shard mesh:
    N=62 cells -> 32 wedge sites."""
    src = [mnt.Source(mnt.GaussianSource(frequency=0.4, fwidth=0.2),
                      component=mnt.Ez, center=mnt.Vector3(3.3, 1.1, 0.5))]
    sim = mnt.Simulation(cell_size=mnt.Vector3(31, 31, 4), resolution=2,
                         boundary_layers=[mnt.PML(2.0)], sources=src,
                         symmetries=[mnt.Rotate4("z")],
                         eps_averaging=False)
    _assert_invariant(_plan_of(sim))
