"""Boundary conditions and ghost-ring construction.

The reference keeps a halo-padded per-rank tile and rewrites the ghost ring
in-place each step: MPI halo exchange first (halo.cpp:6-49), then
``apply_boundary`` overwrites ghosts on *physical* edges (boundary.cpp:12-54):

* Dirichlet: ghost = value (always 0.0 in the driver, main.cpp:102),
* Neumann: ghost mirrors the adjacent interior cell,
* Periodic: **no branch exists** — the ghost keeps its initial fill(0.0)
  forever, so the reference's "periodic" is numerically Dirichlet(0).

The design here is functional: the prognostic state is the *interior*
(ny, nx) array; each step builds a ghost-padded (ny+2, nx+2) view with the BC
values baked in.  Periodic is implemented as a true wrap (decision log #1);
``compat=True`` reproduces the reference's stale-zero ghost behavior exactly.

Corner ghost cells are never read by the 5-point stencils (the reference docs
note h=1 suffices and corners carry garbage), so their values here are
whatever the row pass produces — matching the reference's "bottom/top rows
overwrite corners last" ordering in spirit but irrelevant numerically.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import BCConfig, BCType


def _ghost_line(side_bc: BCType, mirror, wrap, value: float, compat: bool):
    """Ghost values for one face.  ``mirror`` is the adjacent interior line,
    ``wrap`` the opposite-edge interior line."""
    if side_bc == BCType.DIRICHLET:
        return jnp.full_like(mirror, value)
    if side_bc == BCType.NEUMANN:
        return mirror
    # periodic
    if compat:
        # Reference behavior: ghost cells on a periodic physical edge are
        # never written after the initial fill(0.0) (boundary.cpp has no
        # Periodic branch; decomp.cpp:14 is non-periodic) => always zero.
        return jnp.zeros_like(mirror)
    return wrap


def pad_with_ghosts(
    u: jnp.ndarray,
    bc: BCConfig,
    value: float = 0.0,
    compat: bool = False,
) -> jnp.ndarray:
    """Return the (ny+2, nx+2) ghost-padded field for interior ``u`` (ny, nx).

    Array layout is (y, x): axis 0 is y (bottom..top), axis 1 is x
    (left..right), matching the reference's storage and NetCDF order
    (io.cpp:389-394).
    """
    left = _ghost_line(bc.left, u[:, 0], u[:, -1], value, compat)
    right = _ghost_line(bc.right, u[:, -1], u[:, 0], value, compat)
    mid = jnp.concatenate([left[:, None], u, right[:, None]], axis=1)

    bottom = _ghost_line(bc.bottom, mid[0, :], mid[-1, :], value, compat)
    top = _ghost_line(bc.top, mid[-1, :], mid[0, :], value, compat)
    return jnp.concatenate([bottom[None, :], mid, top[None, :]], axis=0)


def apply_boundary(
    u_padded: jnp.ndarray,
    bc: BCConfig,
    value: float = 0.0,
    compat: bool = False,
) -> jnp.ndarray:
    """Functional analogue of the reference's in-place ``apply_boundary``
    (boundary.cpp:12-54) on an already-padded (ny+2, nx+2) array of the
    GLOBAL field: returns a new padded array with the ghost ring rewritten
    per the BCs.  Reference-parity API; equivalent to
    ``pad_with_ghosts(u_padded[1:-1, 1:-1], ...)``.

    Do NOT call this on a per-shard tile inside ``shard_map``: it treats
    every ghost as a physical edge and would clobber interior shards'
    neighbor halos.  The sharded path's BC handling lives in
    ``parallel/halo.py::exchange_and_pad``, which gates the overwrite on
    ``lax.axis_index`` edge masks (the ``MPI_PROC_NULL`` analogue).
    """
    interior = u_padded[1:-1, 1:-1]
    return pad_with_ghosts(interior, bc, value, compat)
