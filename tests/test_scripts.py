"""Script-layer tests: benchmark harness annotation math and IC generator
(reference analogues: run_benchmark.sh:54-68 annotation awk, generate_ic.py)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_annotate_strong_math():
    rb = load_script("run_benchmark")
    rows = [
        (1, 1024, 1024, 200, 8.0, 0.04),
        (2, 1024, 1024, 200, 5.0, 0.025),
        (4, 1024, 1024, 200, 4.0, 0.02),
    ]
    ann, p0 = rb.annotate_strong(rows)
    assert p0 == 1
    # p=1: S=1, E=1, KF=0
    assert ann[0][6:] == (1.0, 1.0, 0.0)
    # p=2: S=1.6, E=0.8, KF=(1/1.6-1/2)/(1-1/2)=0.25
    assert ann[1][6] == pytest.approx(1.6)
    assert ann[1][7] == pytest.approx(0.8)
    assert ann[1][8] == pytest.approx(0.25)
    # p=4: S=2, KF=(0.5-0.25)/(0.75)=1/3
    assert ann[2][6] == pytest.approx(2.0)
    assert ann[2][8] == pytest.approx(1.0 / 3.0)


def test_annotate_strong_without_p1_baseline():
    """A sweep that skips p=1 must not treat the first row as T1:
    the baseline is extrapolated as p0*T_p0 (code-review regression)."""
    rb = load_script("run_benchmark")
    rows = [
        (2, 1024, 1024, 200, 5.0, 0.025),
        (4, 1024, 1024, 200, 3.0, 0.015),
    ]
    ann, p0 = rb.annotate_strong(rows)
    assert p0 == 2
    # baseline row: S = (2*5)/5 = 2, E = 1
    assert ann[0][6] == pytest.approx(2.0)
    assert ann[0][7] == pytest.approx(1.0)
    # p=4: S = 10/3, E = 10/12
    assert ann[1][6] == pytest.approx(10.0 / 3.0)
    assert ann[1][7] == pytest.approx(10.0 / 12.0)


def test_generate_ic_roundtrip(tmp_path):
    gi = load_script("generate_ic")
    out = str(tmp_path / "ic.nc")
    U = gi.make_gaussian_ic(nx=48, ny=32)
    gi.write_netcdf(U, out)

    from climate_sim_tpu.io.netcdf import NetCDFFile

    with NetCDFFile(out) as ds:
        assert ds.dimensions == {"y": 32, "x": 48}
        np.testing.assert_allclose(ds.variables["u"][:], U)
        np.testing.assert_allclose(ds.variables["x"][:], np.arange(48) + 0.5)
        assert ds.variables["u"].getncattr("long_name") == "Gaussian hotspot"


def test_generate_ic_matches_builtin_preset(tmp_path):
    """File IC produced by the generator == the in-framework gaussian preset
    (both implement init.cpp:12-33 cell-center placement)."""
    import jax.numpy as jnp

    from climate_sim_tpu.config import SimConfig
    from climate_sim_tpu.ops.init import apply_initial_condition, gaussian_hotspot

    gi = load_script("generate_ic")
    out = str(tmp_path / "ic.nc")
    gi.write_netcdf(gi.make_gaussian_ic(nx=40, ny=24), out)

    cfg = SimConfig(nx=40, ny=24)
    cfg.ic.mode = "file"
    cfg.ic.path = out
    from_file = np.asarray(apply_initial_condition(cfg, jnp.float64))
    preset = np.asarray(gaussian_hotspot(cfg, jnp.float64))
    np.testing.assert_allclose(from_file, preset, atol=1e-12)


def test_output_enable_false_writes_nothing(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "climate_sim_tpu", "--nx=32", "--ny=32",
         "--steps=4", "--output.enable=false",
         f"--output.dir={tmp_path}/nothing"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "timing: total_max=" in out.stdout
    assert not os.path.exists(f"{tmp_path}/nothing")


def test_generate_ic_reference_flags(tmp_path):
    """Reference CLI spellings work: --amp, --outdir, --outfile
    (reference generate_ic.py:46-53)."""
    script = os.path.join(REPO, "scripts", "generate_ic.py")
    outdir = str(tmp_path / "icdir")
    r = subprocess.run(
        [sys.executable, script, "--nx=12", "--ny=8", "--amp=2.0",
         f"--outdir={outdir}"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    from climate_sim_tpu.io.netcdf import NetCDFFile

    with NetCDFFile(os.path.join(outdir, "ic_global.nc")) as ds:
        u = ds.variables["u"][:]
    assert u.shape == (8, 12)
    gi = load_script("generate_ic")
    np.testing.assert_allclose(u, gi.make_gaussian_ic(nx=12, ny=8, A=2.0))  # --amp respected

    outfile = str(tmp_path / "explicit.nc")
    r = subprocess.run(
        [sys.executable, script, "--nx=12", "--ny=8", f"--outfile={outfile}"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert os.path.getsize(outfile) > 0


def test_generate_ic_hdf5_format_restartable(tmp_path):
    """--format=netcdf4 writes an HDF5-family file that the file-IC path
    reads identically to the classic file (reference interop,
    generate_ic.py:23)."""
    import jax.numpy as jnp

    from climate_sim_tpu.config import SimConfig
    from climate_sim_tpu.ops.init import apply_initial_condition

    gi = load_script("generate_ic")
    U = gi.make_gaussian_ic(nx=40, ny=24)
    h5 = str(tmp_path / "ic_h5.nc")
    c5 = str(tmp_path / "ic_c5.nc")
    gi.write_hdf5(U, h5)
    gi.write_netcdf(U, c5)

    # magic bytes differ...
    assert open(h5, "rb").read(8) == bytes([0x89]) + b"HDF\r\n" + bytes([0x1A, 0x0A])
    assert open(c5, "rb").read(3) == b"CDF"

    # ...but the file-IC reader resolves both to the same field.
    fields = []
    for path in (h5, c5):
        cfg = SimConfig(nx=40, ny=24)
        cfg.ic.mode = "file"
        cfg.ic.path = path
        fields.append(np.asarray(apply_initial_condition(cfg, jnp.float64)))
    np.testing.assert_array_equal(fields[0], fields[1])
    np.testing.assert_allclose(fields[0], U)
