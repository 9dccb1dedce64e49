"""End-to-end driver tests (reference analogues: the integration_* gtest
binaries that shell out to climate_sim and re-read snapshots.nc)."""

import os

import numpy as np
import pytest

from climate_sim_tpu.config import merged_config
from climate_sim_tpu.io.netcdf import NetCDFFile
from climate_sim_tpu.runtime.cli import main as cli_main
from climate_sim_tpu.runtime.driver import run_simulation


def run(tmp_path, extra):
    out = str(tmp_path / "outputs")
    cfg = merged_config(
        None,
        ["--precision=f64", "--output.dir", out] + extra,
    )
    res = run_simulation(cfg)
    return res, os.path.join(out, "snapshots.nc")


def com_x(u):
    """Mass-weighted x centroid at cell centers i+0.5
    (reference: integration_helpers.cpp:76-93)."""
    ny, nx = u.shape
    xs = np.arange(nx) + 0.5
    m = u.sum()
    return float((u.sum(axis=0) * xs).sum() / m)


def test_integration_diffusion_peak_decays(tmp_path):
    """64^2, D=1, 10 steps, periodic: peak decreases, field stays >= 0
    (reference: integration_diffusion.cpp:36-47)."""
    res, nc = run(
        tmp_path,
        ["--nx=64", "--ny=64", "--D=1.0", "--dt=0.2", "--steps=10",
         "--out_every=5", "--bc=periodic"],
    )
    with NetCDFFile(nc) as ds:
        assert ds.dimensions["time"] == 2
        u0 = ds.variables["u"][0, :, :]
        u1 = ds.variables["u"][1, :, :]
    assert u1.max() < u0.max()
    assert u1.min() >= -1e-12
    final = np.asarray(res.u, dtype=np.float64)
    assert final.max() < u1.max()


def test_integration_advection_com_drift(tmp_path):
    """vx=1, dt=1, 6 steps: center-of-mass x moves by 5 +/- 1; mass conserved
    within 5% (reference: integration_advection.cpp:28-35).

    NOTE the reference asserts a +5 drift after 6 steps because its snapshots
    are PRE-update: the last snapshot at n=5 has seen 5 updates... it writes
    at n%out_every==0 with out_every=1, so snapshot k is the state after k
    steps' worth of updates minus one.  We compare IC vs final state after 5
    visible steps the same way: snapshot[5] - snapshot[0] == 5 cells.
    """
    res, nc = run(
        tmp_path,
        ["--nx=64", "--ny=32", "--vx=1.0", "--dt=1.0", "--steps=6",
         "--out_every=1", "--bc=dirichlet", "--ic.sigma_frac=0.05"],
    )
    with NetCDFFile(nc) as ds:
        nt = ds.dimensions["time"]
        assert nt == 6
        first = ds.variables["u"][0, :, :]
        last = ds.variables["u"][nt - 1, :, :]
    drift = com_x(last) - com_x(first)
    assert abs(drift - 5.0) <= 1.0
    assert abs(last.sum() - first.sum()) / first.sum() <= 0.05


def test_integration_nonsquare_axis_order(tmp_path):
    """64x32 grid: snapshot shape is (ny=32, nx=64) — pins the (time,y,x)
    axis order (reference: integration_ic.cpp:28-35)."""
    _, nc = run(tmp_path, ["--nx=64", "--ny=32", "--steps=2", "--out_every=1"])
    with NetCDFFile(nc) as ds:
        u = ds.variables["u"][0, :, :]
        assert u.shape == (32, 64)
        assert u.max() > 1e-6


def test_snapshot_is_pre_update_and_final_not_written(tmp_path):
    """t=0 snapshot equals the IC; state after the final step is never
    written (reference: main.cpp:96-99, SURVEY call-stack note)."""
    res, nc = run(
        tmp_path,
        ["--nx=32", "--ny=32", "--D=0.5", "--dt=0.2", "--steps=10", "--out_every=5"],
    )
    with NetCDFFile(nc) as ds:
        assert ds.dimensions["time"] == 2  # n=0 and n=5
        u0 = ds.variables["u"][0, :, :]
        u5 = ds.variables["u"][1, :, :]
    from climate_sim_tpu.config import SimConfig
    from climate_sim_tpu.ops import gaussian_hotspot
    import jax.numpy as jnp

    ic = np.asarray(gaussian_hotspot(SimConfig(nx=32, ny=32), jnp.float64))
    np.testing.assert_allclose(u0, ic, atol=1e-12)
    # final state differs from every snapshot
    final = np.asarray(res.u, dtype=np.float64)
    assert not np.allclose(final, u5)


def test_write_final_opt_in(tmp_path):
    res, nc = run(
        tmp_path,
        ["--nx=16", "--ny=16", "--D=0.5", "--dt=0.2", "--steps=4",
         "--out_every=2", "--write_final=true"],
    )
    with NetCDFFile(nc) as ds:
        assert ds.dimensions["time"] == 3  # n=0, n=2, final
        last = ds.variables["u"][2, :, :]
    np.testing.assert_allclose(last, np.asarray(res.u, dtype=np.float64), atol=0)


def test_metadata_attrs_schema(tmp_path):
    _, nc = run(
        tmp_path,
        ["--nx=24", "--ny=12", "--D=0.25", "--vx=0.5", "--vy=-1.5",
         "--dt=0.125", "--steps=2", "--out_every=1",
         "--bc.left=neumann", "--bc.bottom=periodic"],
    )
    with NetCDFFile(nc) as ds:
        attrs = {k: ds.getncattr(k) for k in ds.ncattrs()}
    assert attrs["grid"] == "24 x 12"
    assert attrs["dt"] == "0.125000"
    assert attrs["steps"] == "2"
    assert attrs["D"] == "0.250000"
    assert attrs["velocity"] == "(0.500000,-1.500000)"
    assert attrs["boundary_conditions"] == (
        "left=neumann right=dirichlet bottom=periodic top=dirichlet"
    )


def test_dt_clamped_to_cfl(tmp_path, capsys):
    res, _ = run(
        tmp_path,
        ["--nx=16", "--ny=16", "--D=1.0", "--dt=99.0", "--steps=2", "--out_every=1"],
    )
    assert res.clamped
    assert res.dt == pytest.approx(0.25)
    err = capsys.readouterr().err
    assert "clamping" in err


def test_cli_error_exit_on_bad_ic(tmp_path):
    """Bad IC path: nonzero exit and no snapshot file
    (reference: integration_boundary_error.cpp:22-46)."""
    out = str(tmp_path / "outputs")
    rc = cli_main(
        ["--nx=16", "--ny=16", "--steps=2", "--ic.mode=file",
         "--ic.path=/nonexistent/ic.nc", "--output.dir", out]
    )
    assert rc != 0
    assert not os.path.exists(os.path.join(out, "snapshots.nc"))


def test_cli_good_run_exit_zero(tmp_path):
    out = str(tmp_path / "outputs")
    rc = cli_main(
        ["run", "--nx=16", "--ny=16", "--steps=2", "--out_every=1",
         "--precision=f64", "--output.dir", out]
    )
    assert rc == 0
    assert os.path.exists(os.path.join(out, "snapshots.nc"))


def test_cli_config_file(tmp_path):
    out = str(tmp_path / "outputs")
    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(
        "grid: { nx: 20, ny: 10 }\ntime: { dt: 0.1, steps: 3, out_every: 1 }\n"
        f"output: {{ dir: \"{out}\" }}\nprecision: f64\n"
    )
    rc = cli_main([f"--config={cfgfile}", "--ny=12"])
    assert rc == 0
    with NetCDFFile(os.path.join(out, "snapshots.nc")) as ds:
        assert ds.dimensions["y"] == 12  # CLI override beat the YAML
        assert ds.dimensions["x"] == 20


def test_clamped_dt_recorded_in_metadata(tmp_path):
    """Snapshot attrs carry the dt actually used after the CFL clamp, like
    the reference's in-place clamp before write_metadata (main.cpp:42-49)
    (code-review regression)."""
    res, nc = run(tmp_path, ["--D=1.0", "--dt=99.0", "--steps=2", "--out_every=1"])
    assert res.clamped and res.dt < 99.0
    with NetCDFFile(nc) as ds:
        assert ds.getncattr("dt") == f"{res.dt:.6f}"


def test_diagnostics_printed_outside_timed_loop(tmp_path, capsys):
    """--diagnostics_every emits min/max/mean/l2 lines computed on device and
    fetched AFTER the timed loop, so no host sync/transfer distorts the
    timing line (the on-device reduction pass itself stays in the timed
    region — see the driver comment)."""
    run(tmp_path, ["--nx=32", "--ny=16", "--steps=8", "--out_every=4",
                   "--diagnostics_every=1"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    diag = [ln for ln in lines if ln.startswith("diag: ")]
    assert len(diag) == 2  # cadence: once per out_every block
    assert all("min=" in d and "max=" in d and "mean=" in d and "l2=" in d
               for d in diag)
    # all diag lines appear before the timing line (flushed pre-timing-print,
    # post-timer-stop)
    t_idx = next(i for i, ln in enumerate(lines) if ln.startswith("timing:"))
    assert all(lines.index(d) < t_idx for d in diag)
    # values are sane: gaussian IC stays within [0, A]
    first = diag[0]
    mx = float(first.split("max=")[1].split()[0])
    assert 0.0 < mx <= 1.0 + 1e-9


def test_combined_stability_advisory_warning(tmp_path, capsys):
    """dt inside the reference's clamp envelope but past the combined
    advection+diffusion bound: no clamp (reference parity) but an advisory
    warning (docs/numerics.md §Stability; found by the 400-trial sharded
    fuzz)."""
    # dx=dy=1, D=0.15, vy=0.9: safe_dt=1.111, combined=1/1.5=0.667
    res, _ = run(tmp_path, ["--nx=16", "--ny=16", "--D=0.15", "--vy=0.9",
                            "--dt=1.0", "--steps=1", "--out_every=1"])
    err = capsys.readouterr().err
    assert res.dt == 1.0 and not res.clamped  # parity: NOT clamped
    assert "COMBINED" in err and "may diverge" in err

    # inside the combined bound: no advisory
    res, _ = run(tmp_path, ["--nx=16", "--ny=16", "--D=0.15", "--vy=0.9",
                            "--dt=0.5", "--steps=1", "--out_every=1"])
    err = capsys.readouterr().err
    assert "COMBINED" not in err


def test_bf16_long_horizon_advisory_warning(tmp_path, capsys):
    """precision=bf16 past the measured per-step rounding budget
    (BF16_ERR_PER_STEP rel-L2 per step, linear growth) must warn LOUD at
    startup — a 60k-step bf16 run produces decorrelated output.  bf16
    storage rounds once per step, so the estimate counts steps; short bf16
    runs stay silent."""
    from climate_sim_tpu.runtime.driver import BF16_ERR_PER_STEP

    quiet = int(0.05 / BF16_ERR_PER_STEP)  # the last step count under budget
    run(tmp_path, ["--nx=64", "--ny=64", "--precision=bf16",
                   f"--steps={quiet}", f"--out_every={quiet}"])
    err = capsys.readouterr().err
    assert "rounding events" not in err

    run(tmp_path, ["--nx=64", "--ny=64", "--precision=bf16",
                   "--steps=320", "--out_every=320"])
    err = capsys.readouterr().err
    assert "precision=bf16" in err and "320 rounding events" in err


def test_large_out_every_caps_dispatch_program_size(tmp_path, monkeypatch):
    """Snapshot-rarely production cadences (huge out_every) must not
    compile one giant unrolled program per span: the driver splits each
    span into bounded dispatches (found by a 60000-step soak run whose
    single 60000-step program never finished compiling).  520 steps with
    out_every=520 must request only capped program sizes and stay exact."""
    import climate_sim_tpu.runtime.driver as drv

    requested = []
    orig = drv.build_single_device_advance

    def spy(cfg, dt):
        advance = orig(cfg, dt)

        def wrapped(k):
            requested.append(k)
            return advance(k)

        return wrapped

    monkeypatch.setattr(drv, "build_single_device_advance", spy)
    res, nc = run(tmp_path, ["--nx=32", "--ny=24", "--D=0.1", "--vx=0.4",
                             "--dt=0.2", "--steps=520", "--out_every=520",
                             "--mesh.enable=false"])
    assert requested and max(requested) <= 256
    assert sum(set(requested)) >= 520 - 256  # cap + remainder both built

    from climate_sim_tpu.ops.step import reference_step
    import jax.numpy as jnp
    from climate_sim_tpu.ops.init import gaussian_hotspot

    cfg = merged_config(None, ["--precision=f64", "--nx=32", "--ny=24",
                               "--D=0.1", "--vx=0.4", "--dt=0.2",
                               "--steps=520", "--out_every=520"])
    u = gaussian_hotspot(cfg, jnp.float64)
    for _ in range(520):
        u = reference_step(u, cfg, cfg.dt)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(u), atol=1e-12)


def test_restart_chain_bit_exact_vs_continuous(tmp_path):
    """Checkpoint/resume round trip: run N steps with write_final, restart
    from the snapshot for N more, and the final state is BIT-exact to one
    continuous 2N-step run (snapshots store the state losslessly in f64;
    restart reads it back exactly).  Hardware-validated at 1024^2 on the
    real chip; this is the CPU gate."""
    args = ["--nx=64", "--ny=48", "--D=0.05", "--vx=0.5", "--vy=-0.25",
            "--dt=0.1", "--bc.left=periodic", "--bc.right=periodic",
            "--bc.bottom=periodic", "--bc.top=dirichlet",
            "--out_every=400", "--write_final=true"]
    _, nc_a = run(tmp_path / "a", args + ["--steps=8"])
    _, nc_b = run(tmp_path / "b", args + ["--steps=8", "--ic.mode=file",
                                          f"--ic.path={nc_a}"])
    _, nc_c = run(tmp_path / "c", args + ["--steps=16"])
    with NetCDFFile(nc_b) as b, NetCDFFile(nc_c) as c:
        ub = b.variables["u"][-1, :, :]
        uc = c.variables["u"][-1, :, :]
        assert np.array_equal(ub, uc)


@pytest.mark.parametrize("mesh_on", [False, True])
@pytest.mark.parametrize("bcs", [
    # dev.yaml-style mix: one-sided periodic in y
    ("periodic", "periodic", "periodic", "dirichlet"),
    # BOTH axes one-sided periodic
    ("periodic", "dirichlet", "periodic", "neumann"),
])
def test_scheduled_paths_through_driver(tmp_path, mesh_on, bcs):
    """run_simulation end-to-end with one-sided-periodic BC mixes:
    single-device and the 8-device virtual mesh (the sharded per-step
    exchange) must both match the oracle."""
    import jax.numpy as jnp

    from climate_sim_tpu.ops import gaussian_hotspot
    from climate_sim_tpu.ops.step import reference_step

    out = str(tmp_path / "outputs")
    cfg = merged_config(None, [
        "--nx=512", "--ny=128", "--D=0.05", "--vx=0.5", "--vy=-0.25",
        "--dt=0.1", "--steps=19", "--out_every=19",
        f"--bc.left={bcs[0]}", f"--bc.right={bcs[1]}",
        f"--bc.bottom={bcs[2]}", f"--bc.top={bcs[3]}",
        "--output.dir", out,
    ])
    cfg.mesh.enable = mesh_on
    res = run_simulation(cfg)

    u = gaussian_hotspot(cfg, jnp.float32)
    for _ in range(19):
        u = reference_step(u, cfg, res.dt)
    np.testing.assert_allclose(
        np.asarray(res.u), np.asarray(u), atol=5e-5
    )
