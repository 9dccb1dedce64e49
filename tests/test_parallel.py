"""Mesh + halo-exchange tests on the 8-device virtual CPU mesh
(reference analogues: test_decomp_mpi.cpp, test_halo.cpp)."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax
from jax.sharding import PartitionSpec

from climate_sim_tpu.config import BCConfig, BCType, SimConfig
from climate_sim_tpu.ops.step import build_single_device_advance, make_interior_step
from climate_sim_tpu.parallel.halo import build_sharded_advance, exchange_and_pad
from climate_sim_tpu.parallel.mesh import (
    choose_mesh_shape,
    dims_create,
    divisible,
    field_sharding,
    make_mesh,
)
from oracle import gaussian_ic

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_dims_create_near_square():
    """dims product == size, near-square (py is the largest factor <=
    sqrt(n), the MPI_Dims_create contract), px >= py
    (reference: test_decomp_mpi.cpp:6-35)."""
    import math

    for n in range(1, 33):
        px, py = dims_create(n)
        assert px * py == n
        assert px >= py
        best_py = max(d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0)
        assert py == best_py, (n, px, py)


def test_choose_mesh_prefers_divisible():
    assert choose_mesh_shape(8, 1024, 1024) == (4, 2)
    assert choose_mesh_shape(4, 64, 64) == (2, 2)
    # indivisible near-square: picks another factorization that divides
    px, py = choose_mesh_shape(6, 96, 96)
    assert px * py == 6 and 96 % px == 0 and 96 % py == 0
    # explicit request honored
    assert choose_mesh_shape(8, 64, 64, req_x=8) == (8, 1)
    with pytest.raises(ValueError):
        choose_mesh_shape(8, 64, 64, req_x=3)


def test_make_mesh_enumeration_order():
    """make_mesh reshapes the devices in enumeration order (row-major
    (y, x)): the cards of one host are joined all to all, so no placement
    brings mesh neighbours closer."""
    devs = jax.devices()[:8]
    mesh = make_mesh(4, 2)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("y", "x")
    assert [d.id for d in mesh.devices.flat] == [d.id for d in devs]
    m1 = make_mesh(1, 1, jax.devices()[:1])
    assert m1.devices.shape == (1, 1)


def test_halo_exchange_rank_id_faces():
    """Each shard holds its linear id; after exchange each ghost face equals
    the neighbor's id (reference: test_halo.cpp:8-63)."""
    mesh = make_mesh(4, 2)  # px=4, py=2
    cfg = SimConfig(nx=16, ny=8)
    cfg.bc = BCConfig(*(BCType.PERIODIC,) * 4)

    def body(u_local):
        xi = lax.axis_index("x")
        yi = lax.axis_index("y")
        rank = (yi * 4 + xi).astype(u_local.dtype)
        u_local = jnp.zeros_like(u_local) + rank
        return exchange_and_pad(u_local, cfg, px=4, py=2)

    f = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=PartitionSpec("y", "x"),
            out_specs=PartitionSpec("y", "x"),
        )
    )
    u = jnp.zeros((8, 16), dtype=jnp.float64)
    u = jax.device_put(u, field_sharding(mesh))
    padded = np.asarray(f(u))  # global (8+2*2, 16+2*4) = stacked local tiles

    # Check one interior shard: shard (yi=0, xi=1) occupies padded rows 0:6,
    # cols 6:12 in the stacked layout (local tiles are (4+2, 4+2)).
    tile = padded[0:6, 6:12]
    assert np.all(tile[1:-1, 1:-1] == 1.0)        # own rank id
    assert np.all(tile[1:-1, 0] == 0.0)           # left neighbor rank 0
    assert np.all(tile[1:-1, -1] == 2.0)          # right neighbor rank 2
    assert np.all(tile[-1, 1:-1] == 5.0)          # up neighbor rank 5
    assert np.all(tile[0, 1:-1] == 5.0)           # periodic wrap down -> rank 5


@pytest.mark.parametrize("bcs", ["dddd", "nnnn", "pppp", "dnpd", "pdnp"])
@pytest.mark.parametrize("meshdims", [(4, 2), (2, 4), (8, 1), (1, 8), (2, 2)])
def test_sharded_matches_single_device(bcs, meshdims):
    """The explicitly-sharded step must reproduce the single-device result
    bit-for-bit in f64 for every BC mix and mesh shape."""
    BC = {"d": BCType.DIRICHLET, "n": BCType.NEUMANN, "p": BCType.PERIODIC}
    px, py = meshdims
    nx, ny = 32, 16
    cfg = SimConfig(nx=nx, ny=ny, D=0.1, vx=0.5, vy=-0.3, dt=0.4)
    cfg.precision = "f64"
    cfg.bc = BCConfig(left=BC[bcs[0]], right=BC[bcs[1]],
                      bottom=BC[bcs[2]], top=BC[bcs[3]])
    dt = 0.4
    steps = 12

    u0 = jnp.asarray(gaussian_ic(nx, ny), dtype=jnp.float64)

    single = build_single_device_advance(cfg, dt)
    want = np.asarray(single(steps)(u0))

    mesh = make_mesh(px, py)
    assert divisible(mesh, nx, ny)
    interior = make_interior_step(cfg, dt)
    advance = build_sharded_advance(cfg, mesh, dt, interior)
    u_sharded = jax.device_put(u0, field_sharding(mesh))
    got = np.asarray(advance(steps)(u_sharded))

    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_sharded_compat_mode_matches():
    cfg = SimConfig(nx=32, ny=32, D=0.1, vx=0.3, vy=0.3, dt=0.5)
    cfg.precision = "f64"
    cfg.bc = BCConfig(*(BCType.PERIODIC,) * 4)
    cfg.strict_reference_compat = True
    dt = 0.5

    u0 = jnp.asarray(gaussian_ic(32, 32), dtype=jnp.float64)
    want = np.asarray(build_single_device_advance(cfg, dt)(10)(u0))

    mesh = make_mesh(4, 2)
    advance = build_sharded_advance(cfg, mesh, dt, make_interior_step(cfg, dt))
    got = np.asarray(advance(10)(jax.device_put(u0, field_sharding(mesh))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_padded_gspmd_advance_matches_oracle():
    """Grids indivisible along BOTH mesh axes run in a padded carrier of
    the next mesh-multiple shape (decision log #6's padding alternative;
    reference remainder analogue: decomp.cpp:29-30) — exact vs the oracle,
    all BC kinds incl. a one-sided-periodic axis."""
    from climate_sim_tpu.ops.step import reference_step
    from climate_sim_tpu.parallel.halo import build_padded_gspmd_advance

    cfg = SimConfig(nx=53, ny=67, dx=1.0, dy=0.5, D=0.1, vx=-0.7, vy=0.9,
                    dt=0.05, steps=12, out_every=12)
    cfg.bc = BCConfig(BCType.DIRICHLET, BCType.NEUMANN,
                      BCType.PERIODIC, BCType.DIRICHLET)
    mesh = make_mesh(4, 2)
    assert not divisible(mesh, cfg.nx, cfg.ny)
    u0 = jnp.asarray(gaussian_ic(cfg.nx, cfg.ny), dtype=jnp.float64)
    want = u0
    for _ in range(12):
        want = reference_step(want, cfg, cfg.dt)
    got = build_padded_gspmd_advance(cfg, mesh, cfg.dt)(12)(u0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-13)


def _collect_ppermutes(jx):
    """All (axis_name, perm) pairs of every ppermute in a jaxpr, recursing
    into sub-jaxprs (shard_map / pjit / scan bodies)."""
    from jax._src import core as jcore

    out = []

    def subjaxprs(params):
        for v in params.values():
            items = v if isinstance(v, (list, tuple)) else (v,)
            for s in items:
                if isinstance(s, jcore.ClosedJaxpr):
                    yield s.jaxpr
                elif isinstance(s, jcore.Jaxpr):
                    yield s

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "ppermute":
                axes = eqn.params.get("axis_name")
                ax = axes[0] if isinstance(axes, (tuple, list)) else axes
                out.append((ax, tuple(eqn.params["perm"])))
            for s in subjaxprs(eqn.params):
                walk(s)

    walk(jx)
    return out


def _is_truncated(perm, n):
    """True for an edge-truncated shift (n-1 uniform-delta pairs); a cyclic
    shift has n pairs including the wrap pair.  Pair-value inspection is
    ambiguous on n=2 (the +1 wrap pair (1,0) looks like a -1 shift pair),
    so classify by length + uniform unit delta."""
    deltas = {d - s for s, d in perm}
    return len(perm) == n - 1 and deltas in ({1}, {-1})


@pytest.mark.parametrize("meshdims", [(4, 2), (2, 4), (8, 1)])
def test_no_wrap_traffic_on_nonperiodic_axes(meshdims):
    """MPI_PROC_NULL-skip analogue (reference: src/halo.cpp:28-43): axes
    whose BCs are all non-periodic must use EDGE-TRUNCATED ppermute lists —
    no 0<->p-1 wrap pair, whose payload edge shards would immediately
    overwrite with BC ghosts.  Structural check on the jaxpr; behavior is
    covered by the sharded numerics tests."""
    px, py = meshdims
    cfg = SimConfig(nx=64, ny=32, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=8, out_every=8)
    cfg.bc = BCConfig(BCType.DIRICHLET, BCType.NEUMANN,
                      BCType.DIRICHLET, BCType.NEUMANN)
    mesh = make_mesh(px, py)
    adv = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    u = jax.device_put(
        jnp.asarray(gaussian_ic(cfg.nx, cfg.ny), jnp.float32),
        field_sharding(mesh),
    )
    perms = _collect_ppermutes(jax.make_jaxpr(adv(8))(u).jaxpr)
    assert perms, "expected halo-exchange ppermutes in the chunk program"
    sizes = {"x": px, "y": py}
    for ax, perm in perms:
        assert _is_truncated(perm, sizes[ax]), (
            f"non-periodic axis {ax!r} ships wrap traffic: {perm}"
        )


def test_wrap_traffic_kept_on_periodic_axes():
    """The converse: a torus x axis keeps its wrap pair (that payload IS
    the periodic neighbor), while the non-periodic y axis truncates."""
    cfg = SimConfig(nx=64, ny=32, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=8, out_every=8)
    cfg.bc = BCConfig(BCType.PERIODIC, BCType.PERIODIC,
                      BCType.DIRICHLET, BCType.NEUMANN)
    mesh = make_mesh(4, 2)
    adv = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    u = jax.device_put(
        jnp.asarray(gaussian_ic(cfg.nx, cfg.ny), jnp.float32),
        field_sharding(mesh),
    )
    perms = _collect_ppermutes(jax.make_jaxpr(adv(8))(u).jaxpr)
    x_perms = [p for ax, p in perms if ax == "x"]
    y_perms = [p for ax, p in perms if ax == "y"]
    assert x_perms and y_perms
    assert all(len(p) == 4 for p in x_perms), (
        f"periodic x axis lost its wrap payload: {x_perms}"
    )
    assert all(_is_truncated(p, 2) for p in y_perms), (
        f"non-periodic y axis ships wrap traffic: {y_perms}"
    )


@pytest.mark.parametrize("bcs", [
    ("dirichlet", "neumann", "dirichlet", "neumann"),
    ("periodic", "periodic", "periodic", "periodic"),
    ("dirichlet", "neumann", "periodic", "dirichlet"),
    ("periodic", "dirichlet", "periodic", "neumann"),
])
def test_structural_exchange_depth_per_pass(bcs):
    """The exchange-serialization slope, structurally: the jaxpr critical
    path of one step holds exactly 2 ppermute rounds (x faces, then y slabs
    built from the x-extended rows — the same chain as the reference's
    columns-then-full-rows exchange, halo.cpp:28-46) for every BC class,
    torus and one-sided periodic included."""
    from climate_sim_tpu.ops.init import gaussian_hotspot
    from climate_sim_tpu.parallel.analysis import ppermute_critical_depth

    cfg = SimConfig(nx=64, ny=32, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=8, out_every=8)
    cfg.bc = BCConfig(*(getattr(BCType, b.upper()) for b in bcs))
    mesh = make_mesh(4, 2)
    u = jax.device_put(gaussian_hotspot(cfg, jnp.float32), field_sharding(mesh))
    ps = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    assert ppermute_critical_depth(ps(1), u) == 2


@pytest.mark.parametrize("name,bcs,mesh_shape", [
    # All six one-sided orientations, both mesh orientations, plus
    # self-wrap meshes where the periodic axis has a single shard.
    ("os_y_bottom", ("dirichlet", "neumann", "periodic", "dirichlet"), (2, 2)),
    ("os_y_top", ("neumann", "dirichlet", "dirichlet", "periodic"), (2, 4)),
    ("os_x_left", ("periodic", "dirichlet", "neumann", "dirichlet"), (4, 2)),
    ("os_x_right", ("neumann", "periodic", "dirichlet", "neumann"), (2, 2)),
    ("both_axes", ("periodic", "dirichlet", "periodic", "neumann"), (2, 2)),
    ("both_axes_2", ("dirichlet", "periodic", "neumann", "periodic"), (2, 2)),
    ("os_y_selfwrap", ("dirichlet", "neumann", "periodic", "dirichlet"), (8, 1)),
    ("os_x_selfwrap", ("periodic", "dirichlet", "neumann", "dirichlet"), (1, 8)),
])
def test_one_sided_periodic_sharded_matches_oracle(name, bcs, mesh_shape):
    """One-sided-periodic mixes on the sharded per-step path: the cyclic
    exchange delivers the wrap face to the periodic side's edge shards and
    the BC masks pin the other side.  19 steps with mass parked against both
    wrap seams.  (Reference: the exchange works for every BC mix,
    halo.cpp:28-46 + boundary.cpp:12-54.)"""
    from oracle import run_oracle

    px, py = mesh_shape
    cfg = SimConfig(nx=64, ny=32, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=19, out_every=19)
    cfg.bc = BCConfig(*(getattr(BCType, b.upper()) for b in bcs))
    mesh = make_mesh(px, py)
    adv = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    u0 = np.asarray(gaussian_ic(cfg.nx, cfg.ny), np.float64)
    u0 = (u0 + 0.5 * np.roll(u0, cfg.ny // 2 - 2, 0)
          + 0.5 * np.roll(u0, cfg.nx // 2 - 2, 1))
    ref = run_oracle(u0, 19, cfg.D, cfg.vx, cfg.vy, cfg.dt, bc=bcs)
    u = jax.device_put(jnp.asarray(u0, jnp.float64), field_sharding(mesh))
    out = np.asarray(adv(19)(u))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
