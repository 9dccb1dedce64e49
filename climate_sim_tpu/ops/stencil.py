"""Core stencil operators: FTCS diffusion, donor-cell upwind advection, and the
fused unsplit forward-Euler update.

Numerics match the reference exactly:

* diffusion (diffusion.cpp:3-16):
  ``out = u + dt*D*[ (u_{i+1}-2u+u_{i-1})/dx^2 + (u_{j+1}-2u+u_{j-1})/dy^2 ]``
* advection (advection.cpp:5-33): first-order donor-cell upwind with constant
  velocity; ``vx >= 0`` selects the backward difference (one-sided toward the
  upwind direction), and the advective tendency *accumulates* onto the
  diffusion output so one step is the unsplit Euler update
  ``u' = u + dt*D*lap(u) - dt*(vx*du/dx + vy*du/dy)`` reading the same old u
  (main.cpp:104-109, docs/numerics.md).

All functions take a ghost-padded (ny+2, nx+2) array and return the updated
*interior* (ny, nx).  Velocity signs are Python-level (config constants), so
the upwind branch is resolved at trace time and XLA sees straight-line code.

These ``jax.numpy`` functions are the device path: XLA compiles them for the
card.  ``tests/oracle.py`` is the independent NumPy float64 oracle they are
checked against.
"""

from __future__ import annotations

import jax.numpy as jnp


def _neighborhood(up: jnp.ndarray):
    """Center and 4-neighbor views of a padded array."""
    c = up[1:-1, 1:-1]
    xm = up[1:-1, :-2]
    xp = up[1:-1, 2:]
    ym = up[:-2, 1:-1]
    yp = up[2:, 1:-1]
    return c, xm, xp, ym, yp


def laplacian(up: jnp.ndarray, dx: float, dy: float) -> jnp.ndarray:
    c, xm, xp, ym, yp = _neighborhood(up)
    return (xp - 2.0 * c + xm) / (dx * dx) + (yp - 2.0 * c + ym) / (dy * dy)


def diffusion_step(up: jnp.ndarray, D: float, dt: float, dx: float, dy: float) -> jnp.ndarray:
    """Interior FTCS update (reference: diffusion.cpp:3-16)."""
    c = up[1:-1, 1:-1]
    return c + (dt * D) * laplacian(up, dx, dy)


def upwind_gradient(up: jnp.ndarray, vx: float, vy: float, dx: float, dy: float):
    """Donor-cell one-sided differences, sign-switched like advection.cpp:16-27.

    ``vx >= 0`` (including 0) uses the backward difference, matching the
    reference's ``if (vx >= 0.0)`` branch.
    """
    c, xm, xp, ym, yp = _neighborhood(up)
    if vx >= 0.0:
        dudx = (c - xm) / dx
    else:
        dudx = (xp - c) / dx
    if vy >= 0.0:
        dudy = (c - ym) / dy
    else:
        dudy = (yp - c) / dy
    return dudx, dudy


def advection_increment(
    up: jnp.ndarray, vx: float, vy: float, dt: float, dx: float, dy: float
) -> jnp.ndarray:
    """The advective tendency ``-dt*(vx*du/dx + vy*du/dy)`` that the reference
    accumulates onto the diffusion output (advection.cpp:29-31)."""
    dudx, dudy = upwind_gradient(up, vx, vy, dx, dy)
    return (-dt) * (vx * dudx + vy * dudy)


def advection_step(
    up: jnp.ndarray, base: jnp.ndarray, vx: float, vy: float, dt: float, dx: float, dy: float
) -> jnp.ndarray:
    """Accumulating form: ``base + increment`` (reference: advection.cpp:29-31,
    where ``base`` is the partially-updated ``tmp`` field)."""
    return base + advection_increment(up, vx, vy, dt, dx, dy)


def fused_step(
    up: jnp.ndarray,
    D: float,
    vx: float,
    vy: float,
    dt: float,
    dx: float,
    dy: float,
) -> jnp.ndarray:
    """One unsplit forward-Euler step on a padded array -> new interior.

    Exactly diffusion_step followed by the accumulating advection_step
    (main.cpp:106-107), with all neighbor reads from the same old ``up`` —
    composed from those helpers so the upwind/laplacian conventions live in
    one place (everything is jnp-traced, so XLA sees identical code).
    """
    out = diffusion_step(up, D, dt, dx, dy)
    if vx != 0.0 or vy != 0.0:
        out = advection_step(up, out, vx, vy, dt, dx, dy)
    return out


def fused_step_storage(up, D, vx, vy, dt, dx, dy):
    """:func:`fused_step` with bf16-STORAGE semantics: bf16 inputs compute
    in f32 and round once on output (raw bf16 stencil arithmetic measured
    ~4-10x the storage-rounding error).  Other dtypes pass through
    unchanged; every path the driver can route a bf16 run to calls THIS,
    not fused_step, or its numerics silently degrade."""
    if up.dtype == jnp.bfloat16:
        return fused_step(
            up.astype(jnp.float32), D, vx, vy, dt, dx, dy
        ).astype(jnp.bfloat16)
    return fused_step(up, D, vx, vy, dt, dx, dy)
