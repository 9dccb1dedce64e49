"""In-process tests for paths previously reachable only via subprocesses
(runtime CLI, dataset sniffing, mesh-shape requests) —
keeps the CI line-coverage gate (>=90%, reference gcovr.cfg) honest,
since subprocess executions are invisible to in-process coverage tracing.
"""

import numpy as np
import pytest

from climate_sim_tpu.config import SimConfig
from climate_sim_tpu.io.datasets import load_field, sniff_format
from climate_sim_tpu.parallel.mesh import choose_mesh_shape, make_mesh
from climate_sim_tpu.runtime.cli import main as cli_main


# ---------------------------------------------------------------- CLI


def test_cli_help_exits_zero(capsys):
    assert cli_main(["-h"]) == 0
    assert "config" in capsys.readouterr().out


def test_cli_help_anywhere_and_version(capsys):
    # --help anywhere in argv short-circuits (must NOT start a run: the
    # permissive override parser would otherwise swallow it); --version
    # prints the package version.
    assert cli_main(["--nx=64", "--help"]) == 0
    assert "config" in capsys.readouterr().out
    assert cli_main(["--version"]) == 0
    from climate_sim_tpu import __version__

    assert __version__ in capsys.readouterr().out


def test_cli_unknown_flag_warns_but_runs(capsys, tmp_path):
    # Reference-permissive: unknown --flags are ignored (io.cpp:180-217),
    # but a stderr warning flags the typo instead of silently running with
    # defaults.
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
                   "--step=100", f"--output.dir={tmp_path}/o"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "ignored unknown flag --step" in err


def test_cli_known_flag_missing_value_warns(capsys, tmp_path):
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
                   f"--output.dir={tmp_path}/o", "--dt"])
    assert rc == 0
    assert "ignored flag --dt (missing value)" in capsys.readouterr().err


def test_cli_run_subcommand_and_config_error(capsys, tmp_path):
    # "run" prefix is accepted and stripped; bad override -> exit 2.
    assert cli_main(["run", "--nx=-3", f"--output.dir={tmp_path}/o"]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_runtime_error_exits_one(capsys, tmp_path):
    rc = cli_main(["--ic.mode=file", "--ic.path=/nonexistent/x.nc",
                   "--nx=16", "--ny=16", "--steps=1",
                   f"--output.dir={tmp_path}/o"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_cli_platform_env(monkeypatch, tmp_path, capsys):
    # The platform follows JAX_PLATFORMS (no hook of the CLI's own); the
    # banner names the device that ran.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
                   f"--output.dir={tmp_path}/o"])
    assert rc == 0
    assert "device: platform=cpu kind=cpu" in capsys.readouterr().out


# ------------------------------------------------------------- datasets


def test_sniff_format_rejects_garbage(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOTANC__junkjunk")
    with pytest.raises(ValueError, match="not a NetCDF file"):
        sniff_format(str(p))


def _write_h5(path, name, arr):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=arr)


def test_load_field_hdf5_2d_and_last_record(tmp_path):
    a2 = np.arange(12.0).reshape(3, 4)
    p2 = str(tmp_path / "f2.h5")
    _write_h5(p2, "u", a2)
    assert sniff_format(p2) == "hdf5"
    np.testing.assert_array_equal(load_field(p2), a2)

    a3 = np.stack([a2, a2 + 100.0])
    p3 = str(tmp_path / "f3.h5")
    _write_h5(p3, "u", a3)
    np.testing.assert_array_equal(load_field(p3), a2 + 100.0)


def test_load_field_hdf5_errors(tmp_path):
    p = str(tmp_path / "bad.h5")
    _write_h5(p, "v", np.zeros((2, 2)))
    with pytest.raises(KeyError, match="'u' not found"):
        load_field(p)
    p4 = str(tmp_path / "bad4.h5")
    _write_h5(p4, "u", np.zeros((1, 1, 2, 2)))
    with pytest.raises(ValueError, match="must be 2D"):
        load_field(p4)
    p0 = str(tmp_path / "empty.h5")
    _write_h5(p0, "u", np.zeros((0, 2, 2)))
    with pytest.raises(ValueError, match="no records"):
        load_field(p0)


def test_load_field_classic_missing_var(tmp_path):
    from climate_sim_tpu.io.netcdf import NetCDFWriter

    p = str(tmp_path / "c.nc")
    w = NetCDFWriter(p, version=5)
    w.def_dim("y", 2)
    w.def_dim("x", 2)
    w.def_var("v", np.float64, ("y", "x"))
    w.enddef()
    w.put_var("v", np.zeros((2, 2)))
    w.close()
    with pytest.raises(KeyError, match="'u' not found"):
        load_field(p)


# ----------------------------------------------------------------- mesh


def test_choose_mesh_shape_explicit_requests():
    assert choose_mesh_shape(8, 64, 64, req_x=4, req_y=2) == (4, 2)
    assert choose_mesh_shape(8, 64, 64, req_x=2) == (2, 4)
    assert choose_mesh_shape(8, 64, 64, req_y=2) == (4, 2)
    with pytest.raises(ValueError, match="!= device count"):
        choose_mesh_shape(8, 64, 64, req_x=3, req_y=2)
    with pytest.raises(ValueError, match="does not divide"):
        choose_mesh_shape(8, 64, 64, req_x=3)
    with pytest.raises(ValueError, match="does not divide"):
        choose_mesh_shape(8, 64, 64, req_y=3)


def test_make_mesh_insufficient_devices():
    with pytest.raises(ValueError, match="need"):
        make_mesh(64, 64)


# ---------------------------------------------------------------- init


def test_unknown_ic_mode_raises():
    from climate_sim_tpu.ops.init import device_initial_condition
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    cfg = SimConfig(nx=16, ny=16)
    cfg.ic.mode = "bogus"
    mesh = make_mesh(1, 1, jax.devices()[:1])
    sh = NamedSharding(mesh, PartitionSpec())
    with pytest.raises(ValueError, match="Unknown IC mode"):
        device_initial_condition(cfg, np.float32, sh)


def test_device_ic_file_mode_sharded(tmp_path):
    import jax
    from climate_sim_tpu.io.snapshots import SnapshotWriter
    from climate_sim_tpu.ops.init import device_initial_condition
    from climate_sim_tpu.parallel.mesh import field_sharding

    cfg = SimConfig(nx=64, ny=32)
    rng = np.random.default_rng(7)
    frame = rng.standard_normal((32, 64))
    path = str(tmp_path / "ic.nc")
    with SnapshotWriter(path, cfg, use_native=False) as w:
        w.write(frame)
    cfg.ic.mode = "file"
    cfg.ic.path = path
    mesh = make_mesh(4, 2)
    arr = device_initial_condition(cfg, np.float64, field_sharding(mesh))
    np.testing.assert_allclose(np.asarray(jax.device_get(arr)), frame)


# --------------------------------------------------------------- config


def test_yaml_extension_keys():
    from climate_sim_tpu.config import load_yaml_dict

    cfg = load_yaml_dict({
        "precision": "bf16",
        "mesh": {"x": 2, "y": 4, "enable": False},
        "strict_reference_compat": True,
        "diagnostics_every": 3,
        "debug_nans": True,
        "profile_dir": "/tmp/tr",
        "max_devices": 2,
        "distributed": "auto",
        "output": {"path": "/tmp/x.nc", "write_final": True,
                   "enable": True},
        "ic": {"mode": "file", "file": "/tmp/ic.nc", "var": "u"},
    })
    assert cfg.precision == "bf16"
    assert (cfg.mesh.x, cfg.mesh.y, cfg.mesh.enable) == (2, 4, False)
    assert cfg.strict_reference_compat and cfg.diagnostics_every == 3
    assert cfg.debug_nans and cfg.profile_dir == "/tmp/tr"
    assert cfg.max_devices == 2
    assert cfg.distributed == "auto"
    assert cfg.output_path == "/tmp/x.nc" and cfg.write_final
    assert cfg.ic.path == "/tmp/ic.nc" and cfg.ic.var == "u"


def test_validate_extension_errors():
    import pytest as _pytest

    bad = [("precision", "f16"), ("max_devices", -1), ("nx", 0)]
    for attr, val in bad:
        cfg = SimConfig()
        setattr(cfg, attr, val)
        with _pytest.raises(ValueError):
            cfg.validate()


def test_cli_mesh_flags_and_flat_prefix():
    from climate_sim_tpu.config import apply_overrides, parse_cli_overrides

    cfg = SimConfig()
    ov = parse_cli_overrides([
        "--mesh.x=4", "--mesh.y=2", "--mesh.enable=false",
        "--output.enable=false", "--output_prefix=alt",
    ])
    apply_overrides(cfg, ov)
    assert (cfg.mesh.x, cfg.mesh.y, cfg.mesh.enable) == (4, 2, False)
    assert cfg.output_enable is False
    assert cfg.output_prefix == "alt"


def test_config_to_dict_round_trip_strings():
    from climate_sim_tpu.config import config_to_dict

    d = config_to_dict(SimConfig())
    assert d["bc"] == {"left": "dirichlet", "right": "dirichlet",
                       "bottom": "dirichlet", "top": "dirichlet"}
    assert d["nx"] == 256


def test_bad_bc_node_rejected():
    from climate_sim_tpu.config import load_yaml_dict

    with pytest.raises(ValueError, match="bad bc node"):
        load_yaml_dict({"bc": [1, 2, 3]})


# ----------------------------------------- shard-local restart reads


def test_load_field_region_both_formats(tmp_path):
    from climate_sim_tpu.io.datasets import load_field_region, probe_field

    a2 = np.arange(48.0).reshape(6, 8)
    a3 = np.stack([a2, a2 + 100.0])

    p_h5 = str(tmp_path / "r.h5")
    _write_h5(p_h5, "u", a3)

    from climate_sim_tpu.io.snapshots import SnapshotWriter

    cfg = SimConfig(nx=8, ny=6)
    p_nc = str(tmp_path / "r.nc")
    with SnapshotWriter(p_nc, cfg, use_native=False) as w:
        w.write(a2)
        w.write(a2 + 100.0)

    for p in (p_h5, p_nc):
        assert probe_field(p) == (6, 8)
        np.testing.assert_array_equal(
            load_field_region(p, "u", 2, 3, 1, 5), (a2 + 100.0)[2:5, 1:6]
        )
        np.testing.assert_array_equal(load_field_region(p, "u", 0, 6, 0, 8), a2 + 100.0)


def test_device_ic_file_mode_reads_only_shards(tmp_path, monkeypatch):
    """Pod-scale restart contract: the file IC path must request only
    shard-sized regions — never the (ny, nx) global field — and must not
    fall back to the whole-field loader."""
    import jax
    from climate_sim_tpu.io.snapshots import SnapshotWriter
    from climate_sim_tpu.ops import init as init_mod
    from climate_sim_tpu.io import datasets
    from climate_sim_tpu.parallel.mesh import field_sharding

    cfg = SimConfig(nx=64, ny=32)
    rng = np.random.default_rng(3)
    frame = rng.standard_normal((32, 64))
    path = str(tmp_path / "ic.nc")
    with SnapshotWriter(path, cfg, use_native=False) as w:
        w.write(frame)
    cfg.ic.mode = "file"
    cfg.ic.path = path

    regions = []
    opens = []
    real_region = datasets.FieldHandle.read_region
    real_open = datasets.open_field

    def region_spy(self, y0, ny, x0, nx):
        regions.append((ny, nx))
        return real_region(self, y0, ny, x0, nx)

    def open_spy(path_, var_="u"):
        opens.append(path_)
        return real_open(path_, var_)

    monkeypatch.setattr(datasets.FieldHandle, "read_region", region_spy)
    monkeypatch.setattr(datasets, "open_field", open_spy)
    monkeypatch.setattr(
        init_mod, "from_file",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("global read")),
    )

    mesh = make_mesh(4, 2)
    arr = init_mod.device_initial_condition(cfg, np.float64, field_sharding(mesh))
    np.testing.assert_allclose(np.asarray(jax.device_get(arr)), frame)
    assert regions and all(r == (32 // 2, 64 // 4) for r in regions)
    assert len(opens) == 1, "file must be opened once per process, not per shard"


def test_device_ic_file_mode_error_contracts(tmp_path):
    from climate_sim_tpu.ops.init import device_initial_condition
    from climate_sim_tpu.parallel.mesh import field_sharding

    cfg = SimConfig(nx=8, ny=8)
    cfg.ic.mode = "file"
    cfg.ic.path = ""
    mesh = make_mesh(1, 1)
    with pytest.raises(ValueError, match="requires ic.path"):
        device_initial_condition(cfg, np.float32, field_sharding(mesh))

    p = str(tmp_path / "small.h5")
    _write_h5(p, "u", np.zeros((4, 4)))
    cfg.ic.path = p
    with pytest.raises(ValueError, match="does not match grid"):
        device_initial_condition(cfg, np.float32, field_sharding(mesh))


def test_field_handle_bounds_check_all_backends(tmp_path):
    """read_region must raise on out-of-range regions on EVERY backend —
    numpy slice semantics on the HDF5 backends would silently clip
    (regression)."""
    import h5py

    from climate_sim_tpu.io import datasets

    a = np.arange(12.0).reshape(3, 4)
    ph = str(tmp_path / "f.h5")
    with h5py.File(ph, "w") as f:
        f.create_dataset("u", data=a)
    from climate_sim_tpu.io.netcdf import NetCDFWriter

    pc = str(tmp_path / "f.nc")
    with NetCDFWriter(pc) as w:
        w.def_dim("y", 3)
        w.def_dim("x", 4)
        w.def_var("u", np.float64, ("y", "x"))
        w.enddef()
        w.put_var("u", a)

    for p in (ph, pc):
        with datasets.open_field(p) as h:
            np.testing.assert_array_equal(h.read_region(1, 2, 0, 4), a[1:3])
            with pytest.raises(IndexError, match="outside field"):
                h.read_region(2, 2, 0, 4)
            with pytest.raises(IndexError, match="outside field"):
                h.read_region(0, 3, 3, 2)


def test_load_field_classic_fixed_time_dim(tmp_path):
    """A classic file whose 3D time dim is FIXED (not UNLIMITED) — e.g.
    `nccopy -u` / `ncks --fix_rec_dmn` output — still restarts from the
    last record (code-review regression: the classic branch used to pass a
    2D region to a rank-3 variable)."""
    from climate_sim_tpu.io.datasets import load_field_region, open_field
    from climate_sim_tpu.io.netcdf import NetCDFWriter

    a = np.arange(24.0).reshape(2, 3, 4)
    p = str(tmp_path / "fixed_time.nc")
    w = NetCDFWriter(p, version=5)
    w.def_dim("time", 2)  # FIXED, not UNLIMITED
    w.def_dim("y", 3)
    w.def_dim("x", 4)
    w.def_var("u", np.float64, ("time", "y", "x"))
    w.enddef()
    w.put_var("u", a)
    w.close()

    np.testing.assert_array_equal(load_field(p), a[-1])
    np.testing.assert_array_equal(load_field_region(p, "u", 1, 2, 2, 2),
                                  a[-1, 1:3, 2:4])


def test_read_region_rejects_negative_extents(tmp_path):
    """Negative ny/nx must raise on EVERY backend (the HDF5 slice
    semantics would silently return a wrong-shaped block)."""
    from climate_sim_tpu.io.datasets import open_field
    from climate_sim_tpu.io.netcdf import NetCDFWriter

    pc = str(tmp_path / "c.nc")
    w = NetCDFWriter(pc, version=5)
    w.def_dim("y", 4)
    w.def_dim("x", 4)
    w.def_var("u", np.float64, ("y", "x"))
    w.enddef()
    w.put_var("u", np.zeros((4, 4)))
    w.close()
    ph = str(tmp_path / "h.h5")
    _write_h5(ph, "u", np.zeros((4, 4)))

    for p in (pc, ph):
        with open_field(p) as h:
            with pytest.raises(IndexError, match="outside field"):
                h.read_region(0, -1, 0, 4)
            with pytest.raises(IndexError, match="outside field"):
                h.read_region(0, 4, 1, -2)
