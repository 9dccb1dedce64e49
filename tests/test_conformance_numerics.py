"""Numerics across the paths that remain: precision x step count through
``run_simulation`` (259 steps crosses the driver's 256-step dispatch cap),
every upwind branch, odd grid shapes, and the conservation and
maximum-principle properties (reference analogues: integration_diffusion.cpp,
integration_advection.cpp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climate_sim_tpu.runtime.driver import BF16_ERR_PER_STEP, prepare, run_simulation
from oracle import gaussian_ic
from pathcases import (
    GRIDS,
    DEFAULT_GRID,
    bf16_storage_oracle,
    make_cfg,
    oracle_for,
    run_path,
    seam_ic,
    with_path,
)

# A Gaussian parked near the left/top corner, so the Dirichlet, Neumann and
# periodic sides all see mass within the run.
IC = dict(A=1.0, sigma_frac=0.1, xc_frac=0.15, yc_frac=0.85)


@pytest.mark.parametrize("path", ["single", "sharded_2x2", "padded_gspmd"])
@pytest.mark.parametrize("steps", [1, 7, 259])
@pytest.mark.parametrize("precision", ["f64", "f32", "bf16"])
def test_run_simulation_precision_steps(precision, steps, path):
    grid = GRIDS.get(path, DEFAULT_GRID)
    cfg = with_path(make_cfg("bench_mix", grid, precision, steps=steps,
                             out_every=steps), path)
    cfg.ic = dataclasses.replace(cfg.ic, **IC)
    res = run_simulation(cfg, write_output=False)
    assert res.steps == steps and res.u.dtype == jnp.dtype(
        {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}[precision])
    got = np.asarray(jax.device_get(res.u), np.float64)
    u0 = gaussian_ic(cfg.nx, cfg.ny, cfg.dx, cfg.dy, **IC)
    want = oracle_for(cfg, u0, steps)
    if precision == "f64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    elif precision == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        # One bf16 rounding per step: the independent bf16-storage oracle
        # agrees to one bf16 ulp, and the error against f64 stays inside
        # the driver's advisory envelope.
        np.testing.assert_allclose(got, bf16_storage_oracle(cfg, u0, steps),
                                   rtol=2.0 ** -7, atol=1e-6)
        rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel_l2 <= 2.0 ** -8 + BF16_ERR_PER_STEP * steps


@pytest.mark.parametrize("path", ["single", "sharded_2x2", "sharded_4x2"])
@pytest.mark.parametrize("vx,vy,D", [
    (0.0, 0.0, 0.5), (1.0, 0.0, 0.0), (-1.0, 0.5, 0.0), (0.25, -0.75, 0.1),
])
def test_upwind_branches(vx, vy, D, path):
    """Each velocity sign selects a different donor-cell difference
    (advection.cpp:16-27); ``vx >= 0`` includes 0."""
    cfg = make_cfg("one_sided_x_left", D=D, vx=vx, vy=vy)
    u0 = seam_ic(cfg.nx, cfg.ny)
    got, _ = run_path(cfg, path, u0, 5)
    np.testing.assert_allclose(got, oracle_for(cfg, u0, 5), rtol=0, atol=1e-12)


@pytest.mark.parametrize("devices", [1, 4, 8])
@pytest.mark.parametrize("shape", [(64, 8), (8, 64), (33, 17), (17, 33), (12, 9), (2, 16)])
def test_odd_grids_match_oracle(shape, devices):
    """Tall, wide, odd and tiny grids on the mesh the driver picks for 1, 4
    or 8 devices (sharded, partial or padded GSPMD, whichever applies)."""
    nx, ny = shape
    cfg = make_cfg("corner_right_top", (nx, ny), max_devices=devices)
    first, advance, mesh, _, _ = prepare(cfg)
    assert (mesh is None) == (devices == 1)
    u0 = seam_ic(nx, ny)
    u = jax.device_put(jnp.asarray(u0, first.dtype), first.sharding)
    got = np.asarray(jax.device_get(advance(6)(u)), np.float64)
    np.testing.assert_allclose(got, oracle_for(cfg, u0, 6), rtol=0, atol=1e-12)


@pytest.mark.parametrize("path", ["single", "sharded_2x2", "padded_gspmd"])
def test_periodic_advection_conserves_mass(path):
    """Donor-cell upwind on a fully periodic domain is conservative: 50 f32
    steps keep total mass to accumulation error (integration_advection.cpp's
    5% gate, much tighter here)."""
    grid = GRIDS.get(path, DEFAULT_GRID)
    cfg = make_cfg("torus", grid, "f32", D=0.0, vx=0.8, vy=-0.6)
    u0 = seam_ic(*grid)
    got, _ = run_path(cfg, path, u0, 50)
    assert abs(got.sum() - u0.sum()) / u0.sum() < 1e-5


@pytest.mark.parametrize("path", ["single", "sharded_2x2", "padded_gspmd"])
def test_neumann_diffusion_conserves_mass(path):
    """Zero-flux boundaries: diffusion redistributes but never loses mass."""
    grid = GRIDS.get(path, DEFAULT_GRID)
    cfg = make_cfg("neumann4", grid, "f32", D=0.2, vx=0.0, vy=0.0)
    u0 = seam_ic(*grid)
    got, _ = run_path(cfg, path, u0, 50)
    assert abs(got.sum() - u0.sum()) / u0.sum() < 1e-5


@pytest.mark.parametrize("path", ["single", "sharded_2x2", "padded_gspmd"])
def test_diffusion_maximum_principle(path):
    """Explicit diffusion within the CFL bound: the max never increases and
    the min never decreases, step block by step block
    (integration_diffusion.cpp's peak-decay/positivity gate)."""
    grid = GRIDS.get(path, DEFAULT_GRID)
    cfg = make_cfg("bench_mix", grid, "f32", D=0.1, vx=0.0, vy=0.0)
    u = gaussian_ic(*grid)
    prev_max, prev_min = u.max(), u.min()
    for _ in range(5):
        u, _ = run_path(cfg, path, u, 8)
        assert u.max() <= prev_max + 1e-6 and u.min() >= prev_min - 1e-6
        prev_max, prev_min = u.max(), u.min()
    assert prev_max < 0.9  # the peak actually decayed
