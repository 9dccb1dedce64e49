"""Shared cases for the path-conformance tests: every BC class, every path
the driver can take, and the independent NumPy oracle to hold them to.

A *path* is what ``runtime.driver.prepare`` builds for a device count and a
grid: the single-device fori_loop, the explicitly sharded per-step exchange
on a ``px x py`` mesh, partial GSPMD (the grid divides one mesh axis only)
and padded GSPMD (it divides neither).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from climate_sim_tpu.config import BCConfig, BCType, SimConfig
from climate_sim_tpu.runtime import driver as drv
from oracle import apply_bc_oracle, gaussian_ic, oracle_step, run_oracle

D, N, P = "dirichlet", "neumann", "periodic"

# (left, right, bottom, top), plus whether the reference's stale-zero
# periodic emulation (strict_reference_compat) is on.
BC_CLASSES = {
    "dirichlet4": ((D, D, D, D), False),
    "neumann4": ((N, N, N, N), False),
    "torus": ((P, P, P, P), False),
    "bench_mix": ((D, N, P, P), False),
    "one_sided_y_bottom": ((D, N, P, D), False),
    "one_sided_y_top": ((N, D, D, P), False),
    "one_sided_x_left": ((P, D, N, D), False),
    "one_sided_x_right": ((N, P, D, N), False),
    "corner_left_bottom": ((P, D, P, N), False),
    "corner_left_top": ((P, N, N, P), False),
    "corner_right_bottom": ((D, P, P, D), False),
    "corner_right_top": ((N, P, D, P), False),
    "reference_compat": ((P, P, P, P), True),
}

# path -> (mesh x, mesh y) requested; None = one device.
SHARDED = {f"sharded_{x}x{y}": (x, y)
           for x, y in ((1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (8, 1))}
PATHS = dict(single=None, **SHARDED, partial_gspmd=(4, 2), padded_gspmd=(4, 2))

# Grid per path: divisible by every sharded mesh; partial divides x only;
# padded divides neither axis of the 4x2 mesh.
GRIDS = {"partial_gspmd": (48, 37), "padded_gspmd": (45, 37)}
DEFAULT_GRID = (48, 40)


def make_cfg(bc_class="bench_mix", grid=DEFAULT_GRID, precision="f64", **kw):
    bcs, compat = BC_CLASSES[bc_class]
    nx, ny = grid
    base = dict(nx=nx, ny=ny, dx=1.0, dy=0.5, D=0.05, vx=0.5, vy=-0.25,
                dt=0.1, steps=7, out_every=7, precision=precision)
    base.update(kw)
    cfg = SimConfig(**base)
    cfg.bc = BCConfig(*(BCType(b) for b in bcs))
    cfg.strict_reference_compat = compat
    return cfg


def with_path(cfg: SimConfig, path: str) -> SimConfig:
    """Pin the driver to ``path`` through the user-facing knobs."""
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh))
    mesh = PATHS[path]
    if mesh is None:
        cfg.max_devices = 1
    else:
        cfg.mesh.x, cfg.mesh.y = mesh
        cfg.max_devices = mesh[0] * mesh[1]
    return cfg


def seam_ic(nx, ny):
    """A Gaussian plus copies parked against both wrap seams, so every
    boundary carries mass within a few steps."""
    g = gaussian_ic(nx, ny)
    return g + 0.5 * np.roll(g, ny // 2 - 2, 0) + 0.5 * np.roll(g, nx // 2 - 2, 1)


def oracle_for(cfg: SimConfig, u0, steps):
    bcs, compat = tuple(b.value for b in cfg.bc.as_tuple()), cfg.strict_reference_compat
    return run_oracle(u0, steps, cfg.D, cfg.vx, cfg.vy, cfg.dt, cfg.dx, cfg.dy,
                      bc=bcs, periodic_mode="compat" if compat else "wrap")


def bf16_storage_oracle(cfg: SimConfig, u0, steps):
    """NumPy emulation of bf16 storage: f32 arithmetic, one rounding to bf16
    per step (independent of the code under test)."""
    bcs = tuple(b.value for b in cfg.bc.as_tuple())
    mode = "compat" if cfg.strict_reference_compat else "wrap"
    u = np.asarray(u0, np.float64).astype(jnp.bfloat16)
    ny, nx = u.shape
    for _ in range(steps):
        up = np.zeros((ny + 2, nx + 2), np.float32)
        up[1:-1, 1:-1] = u.astype(np.float32)
        apply_bc_oracle(up, bcs, 0.0, mode)
        new = oracle_step(up, cfg.D, cfg.vx, cfg.vy, cfg.dt, cfg.dx, cfg.dy)
        u = new[1:-1, 1:-1].astype(jnp.bfloat16)
    return u.astype(np.float64)


def run_path(cfg: SimConfig, path: str, u0, steps: int):
    """Advance ``u0`` ``steps`` steps on the path ``prepare`` builds for
    ``path``; returns (result on the host, mesh)."""
    cfg = with_path(cfg, path)
    first, advance, mesh, dt, _ = drv.prepare(cfg)
    if PATHS[path] is None:
        assert mesh is None
    else:
        assert (mesh.shape["x"], mesh.shape["y"]) == PATHS[path]
        spec = tuple(first.sharding.spec) + (None,) * 2
        assert spec[:2] == {"partial_gspmd": (None, "x"),
                            "padded_gspmd": (None, None)}.get(path, ("y", "x"))
    u = jax.device_put(jnp.asarray(u0, first.dtype), first.sharding)
    return np.asarray(jax.device_get(advance(steps)(u)), np.float64), mesh
