"""Parity vs the independent NumPy float64 oracle (the stand-in for the C++
reference binary, SURVEY.md §4.4).  Runs on the CPU backend in f64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from climate_sim_tpu.config import BCConfig, BCType, SimConfig
from climate_sim_tpu.ops.step import build_single_device_advance
from oracle import gaussian_ic, run_oracle

BC = {
    "d": BCType.DIRICHLET,
    "n": BCType.NEUMANN,
    "p": BCType.PERIODIC,
}


def make_cfg(nx, ny, D, vx, vy, dt, bcs, compat=False, dx=1.0, dy=1.0):
    cfg = SimConfig(nx=nx, ny=ny, dx=dx, dy=dy, D=D, vx=vx, vy=vy, dt=dt,
                    steps=1, out_every=1)
    cfg.precision = "f64"
    cfg.strict_reference_compat = compat
    cfg.bc = BCConfig(left=BC[bcs[0]], right=BC[bcs[1]],
                      bottom=BC[bcs[2]], top=BC[bcs[3]])
    return cfg


CASES = [
    # (name, D, vx, vy, dt, bcs, compat, steps)
    ("diffusion_dirichlet", 0.2, 0.0, 0.0, 0.5, "dddd", False, 50),
    ("diffusion_neumann", 0.2, 0.0, 0.0, 0.5, "nnnn", False, 50),
    ("diffusion_periodic", 0.2, 0.0, 0.0, 0.5, "pppp", False, 50),
    ("advection_px_py", 0.0, 0.7, 0.3, 0.5, "dddd", False, 40),
    ("advection_nx_ny", 0.0, -0.7, -0.3, 0.5, "nnnn", False, 40),
    ("advection_periodic_wrap", 0.0, 1.0, 0.0, 1.0, "pppp", False, 100),
    ("mixed_dev_yaml", 0.05, 0.5, 0.0, 0.1, "dnpd", False, 60),
    ("compat_periodic", 0.1, 0.4, -0.2, 0.4, "pppp", True, 50),
    ("anisotropic", 0.1, 0.5, -0.5, 0.1, "dndn", False, 30),
]


@pytest.mark.parametrize("name,D,vx,vy,dt,bcs,compat,steps", CASES)
def test_parity_vs_oracle(name, D, vx, vy, dt, bcs, compat, steps):
    nx, ny = 48, 40
    dx, dy = (1.0, 1.0) if name != "anisotropic" else (0.5, 2.0)
    cfg = make_cfg(nx, ny, D, vx, vy, dt, bcs, compat, dx, dy)

    u0 = gaussian_ic(nx, ny, dx, dy)
    advance = build_single_device_advance(cfg, dt)
    got = np.asarray(advance(steps)(jnp.asarray(u0, dtype=jnp.float64)))

    bc_names = {
        "d": "dirichlet", "n": "neumann", "p": "periodic",
    }
    expect = run_oracle(
        u0, steps, D, vx, vy, dt, dx, dy,
        bc=tuple(bc_names[c] for c in bcs),
        periodic_mode="compat" if compat else "wrap",
    )
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-12)


def test_compat_periodic_equals_dirichlet_zero():
    """The reference's periodic IS Dirichlet(0) numerically: ghosts start at
    fill(0.0) and no code path ever writes them (boundary.cpp, decomp.cpp:14)."""
    u0 = gaussian_ic(32, 32)
    a = run_oracle(u0, 30, 0.2, 0.5, 0.0, 0.4, bc=("periodic",) * 4,
                   periodic_mode="compat")
    b = run_oracle(u0, 30, 0.2, 0.5, 0.0, 0.4, bc=("dirichlet",) * 4)
    np.testing.assert_array_equal(a, b)


def test_true_periodic_differs_from_compat():
    """Our default periodic (real wrap) must NOT match the reference's no-op
    once mass reaches the boundary."""
    # hotspot near the right edge so wrap matters quickly
    u0 = gaussian_ic(32, 32, xc_frac=0.95)
    wrap = run_oracle(u0, 20, 0.0, 1.0, 0.0, 1.0, bc=("periodic",) * 4,
                      periodic_mode="wrap")
    compat = run_oracle(u0, 20, 0.0, 1.0, 0.0, 1.0, bc=("periodic",) * 4,
                        periodic_mode="compat")
    assert not np.allclose(wrap, compat)
    # wrap conserves mass exactly for pure advection on a torus
    assert wrap.sum() == pytest.approx(u0.sum(), rel=1e-12)


def test_long_horizon_parity_1000_steps():
    """1000-step f64 parity vs the NumPy oracle (scaled to a CPU-testable
    grid).  The same gate also runs against the reference's own COMPILED
    numerics in tests/test_cpp_reference_parity.py — this NumPy variant
    stays as the environment-independent fallback (SURVEY.md §4.4)."""
    cfg = make_cfg(128, 96, 0.05, 0.5, -0.25, 0.1, "dnpp")
    u0 = gaussian_ic(128, 96)
    adv = build_single_device_advance(cfg, cfg.dt)
    ours = np.asarray(jax.device_get(adv(1000)(jnp.asarray(u0, dtype=jnp.float64))))
    ref = run_oracle(
        u0, 1000, 0.05, 0.5, -0.25, 0.1,
        bc=("dirichlet", "neumann", "periodic", "periodic"),
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
