"""chip_smoke.py's phase functions at tiny size on the CPU backend.

The script itself refuses to run without a GPU; its phases take the
devices they compare as arguments, so here they run CPU against CPU (the
comparisons must then be exact) at a few cells per axis.  The gpu-marked
case runs phase b at full size on the card (MNT_TEST_GPU=1, see conftest).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import pytest

import chip_smoke as C
import meep_nl_tpu as mp


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        C.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    shutil.copy(C.__file__, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 400.00 W", "NVIDIA H100 80GB HBM3", 400.0),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
])
def test_parse_smi(line, name, watts):
    assert C.parse_smi(line) == (name, watts)


def test_compare_fields_flags_a_perturbed_field():
    rng = np.random.default_rng(0)
    ref = {c: rng.standard_normal((6, 5, 4)).astype(np.float32)
           for c in ("ex", "ey", "hz")}
    errs = C.compare_fields({k: v.copy() for k, v in ref.items()}, ref,
                            1e-4)
    assert errs == {"ex": 0.0, "ey": 0.0, "hz": 0.0}
    bad = {k: v.copy() for k, v in ref.items()}
    bad["ey"][3, 2, 1] += 0.05
    with pytest.raises(AssertionError, match="ey"):
        C.compare_fields(bad, ref, 1e-4)
    nan = {k: v.copy() for k, v in ref.items()}
    nan["hz"][0, 0, 0] = np.nan
    with pytest.raises(AssertionError, match="hz"):
        C.compare_fields(nan, ref, 1e-4)


def test_compare_fields_uses_the_dominant_scale():
    """Roundoff in a weak component is judged against the strongest."""
    ref = {"ez": np.ones(100), "hz": np.full(100, 1e-4)}
    got = {"ez": ref["ez"].copy(), "hz": ref["hz"] * (1 + 1e-3)}
    errs = C.compare_fields(got, ref, 1e-4)
    assert errs["hz"] == pytest.approx(1e-7, rel=1e-6)


def test_bytes_per_cell_step_hand_count():
    """2D TM vacuum, 8x8 cells (9x9 sites), one point source: six float32
    field arrays read and written (6*81*4*2 = 3888 B), the int32 step
    counter (4*2), six float32 masks read (6*81*4 = 1944) and the source's
    (1,2) int32 index and two float32 amplitudes (8+4+4): 5856 B over 64
    cells."""
    sim = mp.Simulation(cell_size=mp.Vector3(2, 2), resolution=4,
                        sources=[mp.Source(mp.GaussianSource(1.0,
                                                             fwidth=0.5),
                                           component=mp.Ez,
                                           center=mp.Vector3())])
    sim.init_sim()
    assert C.bytes_per_cell_step(sim._plan, sim._state) == 5856 / 64


def test_hbm_peak_table():
    assert C.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no published HBM"):
        C.hbm_peak("cpu")


def test_result_line():
    devs = jax.devices()[:4]
    rec = json.loads(C.result_line(devs))
    assert rec == {"ok": True, "device": {
        "platform": "cpu", "kind": devs[0].device_kind, "count": 4}}


def test_match_modes():
    ref = [(0.118, 78.0, 0.01), (0.1755, 2000.0, 0.02), (0.15, 5.0, 1e-3)]
    assert C.match_modes(list(ref), ref, 1e-5) == 0.0
    shifted = [(0.118 * (1 + 1e-4), 78.0, 0.01)] + ref[1:]
    with pytest.raises(AssertionError, match="differ"):
        C.match_modes(shifted, ref, 1e-5)
    with pytest.raises(AssertionError, match="no well-formed"):
        C.match_modes([], [(0.15, 5.0, 1e-3)], 1e-5)


def test_phase_b_cpu_against_cpu(cpu):
    errs = C.phase_b(cpu, cpu, cells=12, steps=24)
    assert set(errs) == {"ex", "ey", "ez", "hx", "hy", "hz", "flux"}
    assert max(errs.values()) == 0.0


def test_time_cell_tiny(cpu):
    rec = C.time_cell(cpu, "flagship", 12, material=True, flux=True,
                      steps=8, repeats=1)
    assert rec["cells"] == [12, 12, 12] and rec["gcells_per_s"] > 0
    assert rec["rasterizer"] == "NumPy"
    assert rec["bytes_per_cell_step"] > 0


def test_phase_four_on_virtual_devices():
    """The 4-card phase rehearsed on four virtual CPU devices."""
    out = C.phase_four(jax.devices()[:4], cells=(24, 12, 12), steps=12)
    assert max(out["errors"].values()) <= 1e-6
    assert set(out["step_s"]) == {"1", "4"}


@pytest.mark.gpu
def test_phase_b_on_gpu(gpu_device, cpu):
    errs = C.phase_b(gpu_device, cpu)
    assert max(errs.values()) <= 1e-4
