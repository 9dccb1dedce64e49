"""Step-function assembly: wires ghost construction to the fused stencil, for
both the single-device and sharded paths.

The reference's time-loop body (main.cpp:101-109) is: halo exchange ->
apply_boundary -> copy -> diffusion_step -> advection_step (accumulating) ->
swap.  Functionally that is exactly ``u' = fused_step(pad_with_ghosts(u))``,
which is what both paths compute here, as plain ``jax.numpy`` that XLA
compiles for the device.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SimConfig
from .boundary import pad_with_ghosts
from .stencil import fused_step, fused_step_storage


def make_interior_step(cfg: SimConfig, dt: float) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Return fn: ghost-padded tile (my+2, mx+2) -> updated interior (my, mx).

    bf16 is a storage format: the step computes in f32 and rounds once on
    output (see :func:`fused_step_storage`)."""

    def step(up: jnp.ndarray) -> jnp.ndarray:
        return fused_step_storage(up, cfg.D, cfg.vx, cfg.vy, dt, cfg.dx, cfg.dy)

    return step


def build_single_device_advance(cfg: SimConfig, dt: float):
    """``advance(k)`` -> jitted fn advancing the global (ny, nx) field k steps
    on one device (or under GSPMD auto-partitioning if the input is sharded):
    each step is pad_with_ghosts + the fused stencil inside a fori_loop.
    """
    interior = make_interior_step(cfg, dt)
    compat = cfg.strict_reference_compat

    def one_step(u: jnp.ndarray) -> jnp.ndarray:
        up = pad_with_ghosts(u, cfg.bc, 0.0, compat)
        return interior(up)

    @functools.lru_cache(maxsize=None)
    def advance(k: int):
        def body(u):
            return lax.fori_loop(0, k, lambda i, v: one_step(v), u)

        return jax.jit(body)

    return advance


def reference_step(u: jnp.ndarray, cfg: SimConfig, dt: float) -> jnp.ndarray:
    """Un-jitted single step on the global field (testing convenience)."""
    up = pad_with_ghosts(u, cfg.bc, 0.0, cfg.strict_reference_compat)
    return fused_step(up, cfg.D, cfg.vx, cfg.vy, dt, cfg.dx, cfg.dy)
