"""Device-mesh construction: the JAX analogue of the reference's 2D Cartesian
process grid (reference: src/decomp.cpp:5-34).

``MPI_Dims_create(size, 2, dims)`` picks a near-square factorization with
``dims[0] >= dims[1]``; axis 0 is x (left/right neighbors), axis 1 is y.
Here we factor the device count the same way onto a ``jax.sharding.Mesh``
with named axes ``('y', 'x')`` (array layout is (y, x)), preferring factor
pairs that evenly divide the grid so shards are equal-sized — where the
reference gives the last rank the remainder (decomp.cpp:29-30), we instead
require/choose divisible layouts and fall back to XLA's automatic (GSPMD)
partitioning for indivisible cases (decision log #6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def dims_create(size: int) -> Tuple[int, int]:
    """Near-square factorization (px, py) with px >= py, px*py == size —
    the MPI_Dims_create(…, 2, …) contract."""
    best = (size, 1)
    a = int(size**0.5)
    while a >= 1:
        if size % a == 0:
            best = (size // a, a)
            break
        a -= 1
    return best


def choose_mesh_shape(
    n_devices: int,
    nx: int,
    ny: int,
    req_x: Optional[int] = None,
    req_y: Optional[int] = None,
) -> Tuple[int, int]:
    """Pick (px, py) for the ('x','y') decomposition of an (ny, nx) grid.

    Honors explicit requests; otherwise scans factorizations from
    near-square outward and returns the first whose shards divide the grid
    evenly.  Falls back to the near-square factorization even if indivisible
    (callers then use GSPMD auto-partitioning).
    """
    if req_x is not None and req_y is not None:
        if req_x * req_y != n_devices:
            raise ValueError(
                f"mesh {req_x}x{req_y} != device count {n_devices}"
            )
        return req_x, req_y
    if req_x is not None:
        if n_devices % req_x:
            raise ValueError(f"mesh.x={req_x} does not divide {n_devices}")
        return req_x, n_devices // req_x
    if req_y is not None:
        if n_devices % req_y:
            raise ValueError(f"mesh.y={req_y} does not divide {n_devices}")
        return n_devices // req_y, req_y

    # All factor pairs, ordered by closeness to square (MPI_Dims_create-like,
    # biased px >= py), preferring even division of the grid.
    pairs: List[Tuple[int, int]] = []
    a = int(n_devices**0.5)
    while a >= 1:
        if n_devices % a == 0:
            pairs.append((n_devices // a, a))
            if a != n_devices // a:
                pairs.append((a, n_devices // a))
        a -= 1
    for px, py in pairs:
        if nx % px == 0 and ny % py == 0:
            return px, py
    return dims_create(n_devices)


def make_mesh(
    n_x: int, n_y: int, devices: Optional[Sequence[jax.Device]] = None
) -> Mesh:
    """Create a ('y', 'x')-named mesh of shape (n_y, n_x).

    The devices are reshaped in enumeration order: the cards of one host are
    joined all to all, so no placement makes a mesh neighbour closer.
    """
    import numpy as np

    devs = list(devices) if devices is not None else jax.devices()
    if len(devs) < n_x * n_y:
        raise ValueError(f"need {n_x * n_y} devices, have {len(devs)}")
    grid = np.asarray(devs[: n_x * n_y]).reshape(n_y, n_x)
    return Mesh(grid, axis_names=("y", "x"))


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of the global (ny, nx) field over the mesh."""
    return NamedSharding(mesh, PartitionSpec("y", "x"))


def divisible(mesh: Mesh, nx: int, ny: int) -> bool:
    px = mesh.shape["x"]
    py = mesh.shape["y"]
    return nx % px == 0 and ny % py == 0
