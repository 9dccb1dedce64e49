"""Black-box process-level integration tests: every probe shells out to the
installed module entry points (``python -m climate_sim_tpu`` /
``python -m visualization.cli``) exactly as a user would, and asserts on
exit codes, stdout contracts, and on-disk artifacts only.

Reference analogue: the integration gtest binaries that exec the real
``climate_sim`` executable and re-read snapshots.nc
(reference: tests/simulation/integration/integration_helpers.cpp:17-25).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sim(args, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "climate_sim_tpu"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def vis(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "visualization.cli"] + args,
        cwd=REPO, env=dict(os.environ, MPLBACKEND="Agg"),
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.fixture(scope="module")
def good_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bb") / "outputs")
    r = sim(["--nx=48", "--ny=32", "--steps=8", "--out_every=4",
             f"--output.dir={out}"])
    assert r.returncode == 0, r.stderr
    return out, r


def test_good_run_contract(good_run):
    out, r = good_run
    assert "climate-sim-tpu" in r.stdout          # banner
    assert "IC min/max:" in r.stdout
    assert "timing: total_max=" in r.stdout       # greppable timing line
    assert "throughput:" in r.stdout
    path = os.path.join(out, "snapshots.nc")
    assert os.path.exists(path)

    from climate_sim_tpu.io.netcdf import NetCDFFile

    with NetCDFFile(path) as ds:
        assert ds.dimensions == {"time": 2, "y": 32, "x": 48}
        u0 = ds.variables["u"][0, :, :]
        assert np.isfinite(u0).all() and u0.max() > 0


@pytest.mark.parametrize("bad_args", [
    ["--bc.left=bogus"],
    ["--dt=0"],
    ["--config=/nonexistent/nope.yaml"],
    ["--nx=abc"],
    ["--nx=-4"],
])
def test_config_errors_exit_2(bad_args, tmp_path):
    r = sim(bad_args + [f"--output.dir={tmp_path}/o"])
    assert r.returncode == 2, (r.returncode, r.stdout, r.stderr)
    assert r.stderr.strip(), "expected a clean error message on stderr"


def test_bad_ic_file_exit_1_no_snapshot(tmp_path):
    out = f"{tmp_path}/o"
    r = sim(["--ic.mode=file", "--ic.path=/nonexistent/ic.nc",
             f"--output.dir={out}", "--nx=16", "--ny=16", "--steps=2"])
    assert r.returncode == 1
    assert not os.path.exists(os.path.join(out, "snapshots.nc"))


def test_vis_show_blackbox(good_run, tmp_path):
    out, _ = good_run
    png = str(tmp_path / "s.png")
    r = vis(["show", "--dir", out, "--save", png, "--overlay-minmax",
             "--show-meta"])
    assert r.returncode == 0, r.stderr
    assert os.path.getsize(png) > 0


def test_vis_empty_dir_exits_nonzero(tmp_path):
    r = vis(["show", "--dir", str(tmp_path), "--save", str(tmp_path / "x.png")])
    assert r.returncode != 0
    assert "No snapshots" in (r.stderr + r.stdout)


def _read_all_steps(out):
    from climate_sim_tpu.io.netcdf import NetCDFFile

    with NetCDFFile(os.path.join(out, "snapshots.nc")) as ds:
        return np.asarray(ds.variables["u"][:, :, :])


def test_diffusion_peak_decays_blackbox(tmp_path):
    """Peak decreases and field stays nonnegative under pure diffusion
    (reference: integration_diffusion.cpp:36-47 — 64^2, D=1, periodic)."""
    out = f"{tmp_path}/o"
    r = sim(["--nx=64", "--ny=64", "--D=1.0", "--dt=0.2", "--steps=10",
             "--out_every=9", "--bc=periodic", f"--output.dir={out}"])
    assert r.returncode == 0, r.stderr
    frames = _read_all_steps(out)
    assert frames.shape[0] == 2          # steps 0 and 9 (pre-update cadence)
    assert frames[1].max() < frames[0].max()
    assert (frames[1] >= -1e-12).all()


def test_advection_com_drift_blackbox(tmp_path):
    """Center of mass moves by vx*dt*steps within +-1 cell and mass is
    conserved within 5% (reference: integration_advection.cpp:28-35)."""
    out = f"{tmp_path}/o"
    r = sim(["--nx=64", "--ny=64", "--vx=1.0", "--dt=1.0", "--steps=6",
             "--out_every=5", "--bc=periodic", f"--output.dir={out}"])
    assert r.returncode == 0, r.stderr
    frames = _read_all_steps(out)
    cells_x = np.arange(64) + 0.5        # mass centroid at cell centers
    com = [float((f.sum(axis=0) * cells_x).sum() / f.sum()) for f in frames]
    assert abs((com[1] - com[0]) - 5.0) <= 1.0
    assert abs(frames[1].sum() - frames[0].sum()) <= 0.05 * frames[0].sum()


def test_diagnostics_flag_blackbox(tmp_path):
    r = sim(["--nx=32", "--ny=16", "--steps=4", "--out_every=2",
             "--diagnostics_every=1", f"--output.dir={tmp_path}/o"])
    assert r.returncode == 0, r.stderr
    assert "diag: step=" in r.stdout
