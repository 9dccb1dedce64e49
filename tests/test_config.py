"""Config-system tests (reference analogue: tests/simulation/unit/test_io.cpp
YAML/CLI sections)."""

import os

import pytest

from climate_sim_tpu.config import (
    BCType,
    SimConfig,
    bc_from_string,
    bc_to_string,
    extract_config_path,
    load_yaml_file,
    merged_config,
    parse_cli_overrides,
)

REFERENCE_DEV = os.path.join(os.path.dirname(__file__), "fixtures", "reference_dev.yaml")


def test_defaults():
    cfg = SimConfig()
    assert (cfg.nx, cfg.ny) == (256, 256)
    assert (cfg.dx, cfg.dy) == (1.0, 1.0)
    assert (cfg.D, cfg.vx, cfg.vy) == (0.0, 0.0, 0.0)
    assert (cfg.dt, cfg.steps, cfg.out_every) == (0.1, 100, 50)
    assert cfg.output_prefix == "snap"
    assert all(b == BCType.DIRICHLET for b in cfg.bc.as_tuple())
    assert cfg.ic.mode == "preset" and cfg.ic.preset == "gaussian_hotspot"
    assert cfg.ic.A == 1.0 and cfg.ic.sigma_frac == 0.05
    assert cfg.ic.xc_frac == 0.5 and cfg.ic.yc_frac == 0.5


def test_bc_aliases_roundtrip():
    assert bc_from_string("Dirichlet") == BCType.DIRICHLET
    assert bc_from_string("FIXED") == BCType.DIRICHLET
    assert bc_from_string("neumann") == BCType.NEUMANN
    assert bc_from_string("noflux") == BCType.NEUMANN
    assert bc_from_string("zero-flux") == BCType.NEUMANN
    assert bc_from_string("periodic") == BCType.PERIODIC
    assert bc_from_string("period") == BCType.PERIODIC
    with pytest.raises(ValueError):
        bc_from_string("bogus")
    for b in BCType:
        assert bc_from_string(bc_to_string(b)) == b


def test_yaml_nested(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(
        """
grid:    { nx: 128, ny: 64, dx: 0.5, dy: 2.0 }
physics: { D: 0.05, vx: 0.5, vy: -0.25 }
time:    { dt: 0.01, steps: 42, out_every: 7 }
bc:
  left: dirichlet
  right: neumann
  bottom: periodic
  top: fixed
output: { prefix: "dev" }
ic:
  preset: gaussian_hotspot
  file: "inputs/ic_global.nc"
  params:
    A: 2.0
    sigma_frac: 0.1
"""
    )
    cfg = load_yaml_file(str(p))
    assert (cfg.nx, cfg.ny, cfg.dx, cfg.dy) == (128, 64, 0.5, 2.0)
    assert (cfg.D, cfg.vx, cfg.vy) == (0.05, 0.5, -0.25)
    assert (cfg.dt, cfg.steps, cfg.out_every) == (0.01, 42, 7)
    assert cfg.bc.left == BCType.DIRICHLET
    assert cfg.bc.right == BCType.NEUMANN
    assert cfg.bc.bottom == BCType.PERIODIC
    assert cfg.bc.top == BCType.DIRICHLET
    assert cfg.output_prefix == "dev"
    # dev.yaml spellings accepted (decision log #4; the reference silently
    # drops ic.file / ic.params.*)
    assert cfg.ic.path == "inputs/ic_global.nc"
    assert cfg.ic.A == 2.0 and cfg.ic.sigma_frac == 0.1


def test_yaml_flat(tmp_path):
    p = tmp_path / "flat.yaml"
    p.write_text("nx: 32\nny: 16\nD: 0.1\ndt: 0.2\nsteps: 5\nout_every: 2\noutput_prefix: foo\n")
    cfg = load_yaml_file(str(p))
    assert (cfg.nx, cfg.ny) == (32, 16)
    assert cfg.D == 0.1 and cfg.dt == 0.2
    assert (cfg.steps, cfg.out_every) == (5, 2)
    assert cfg.output_prefix == "foo"


def test_yaml_bc_scalar(tmp_path):
    p = tmp_path / "bc.yaml"
    p.write_text("bc: noflux\n")
    cfg = load_yaml_file(str(p))
    assert all(b == BCType.NEUMANN for b in cfg.bc.as_tuple())


def test_cli_equals_and_space_forms():
    o = parse_cli_overrides(["--nx=100", "--ny", "50", "--dt", "0.5", "--D=1.5"])
    assert o["nx"] == 100 and o["ny"] == 50
    assert o["dt"] == 0.5 and o["D"] == 1.5


def test_cli_bc_and_ic_keys():
    o = parse_cli_overrides(
        ["--bc.left=periodic", "--bc.top", "neumann", "--ic.preset=constant_zero",
         "--ic.A=3.0", "--ic.var", "temp", "--output.prefix=x"]
    )
    assert o["bc.left"] == BCType.PERIODIC
    assert o["bc.top"] == BCType.NEUMANN
    assert o["ic.preset"] == "constant_zero"
    assert o["ic.A"] == 3.0
    assert o["ic.var"] == "temp"
    assert o["output.prefix"] == "x"


def test_cli_unknown_flags_ignored():
    o = parse_cli_overrides(["--config=whatever.yaml", "--unknown=1", "positional"])
    assert "unknown" not in o and "config" not in o


def test_precedence_yaml_then_cli(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("grid: { nx: 111 }\nphysics: { D: 0.5 }\n")
    cfg = merged_config(str(p), ["--nx=222", "--vy", "-1.0"])
    assert cfg.nx == 222  # CLI wins over YAML
    assert cfg.D == 0.5  # YAML wins over defaults
    assert cfg.vy == -1.0


def test_validation_raises():
    for args in (["--nx=0"], ["--ny=-1"], ["--dx=0"], ["--dy=-2"], ["--dt=0"],
                 ["--steps=0"], ["--out_every=0"]):
        with pytest.raises(ValueError):
            merged_config(None, args)


def test_extract_config_path():
    assert extract_config_path(["--config=a.yaml"]) == "a.yaml"
    assert extract_config_path(["--config", "b.yaml"]) == "b.yaml"
    assert extract_config_path(["--nx=1"]) is None
    # last one wins
    assert extract_config_path(["--config=a.yaml", "--config", "c.yaml"]) == "c.yaml"


def test_reference_dev_yaml_parses():
    """The reference's shipped config must load verbatim."""
    cfg = load_yaml_file(REFERENCE_DEV)
    assert (cfg.nx, cfg.ny) == (512, 512)
    assert cfg.D == 0.05 and cfg.vx == 0.5
    assert cfg.bc.bottom == BCType.PERIODIC and cfg.bc.right == BCType.NEUMANN
    assert cfg.ic.path == "inputs/ic_global.nc"
    assert cfg.ic.A == 1.0 and cfg.ic.sigma_frac == 0.05


def test_empty_yaml_blocks_tolerated(tmp_path):
    """Present-but-empty blocks (null nodes) act like absent blocks, as in
    yaml-cpp (code-review regression)."""
    p = tmp_path / "empty.yaml"
    p.write_text("grid:\nphysics:\ntime:\nbc: dirichlet\n")
    cfg = load_yaml_file(str(p))
    assert (cfg.nx, cfg.ny, cfg.D) == (256, 256, 0.0)  # defaults survive


def test_cli_can_override_invalid_yaml_value(tmp_path):
    """Validation runs only after the merge (io.cpp:363-376 precedence), so
    the CLI can rescue an invalid YAML value (code-review regression)."""
    p = tmp_path / "bad.yaml"
    p.write_text("time: { steps: 0 }\n")
    cfg = merged_config(str(p), ["--steps=10"])
    assert cfg.steps == 10
    with pytest.raises(ValueError):
        merged_config(str(p), [])  # still invalid without the override


def test_output_prefix_honored_when_non_default():
    """decision log #3: explicit prefix names the file; the reference's
    hardcoded snapshots.nc stays the default."""
    cfg = merged_config(None, ["--output.prefix=exp1", "--output.dir=/tmp/o"])
    assert cfg.resolved_output_path() == "/tmp/o/exp1.nc"
    cfg = merged_config(None, ["--output.dir=/tmp/o"])
    assert cfg.resolved_output_path() == "/tmp/o/snapshots.nc"
    cfg = merged_config(None, ["--output.path=/x/y.nc", "--output.prefix=exp1"])
    assert cfg.resolved_output_path() == "/x/y.nc"


def test_config_to_dict_roundtrips_through_loader():
    """config_to_dict output (the metadata/logging form) must reload to an
    equal config — flat output keys, string BCs, None mesh axes and all
    (code-review regression)."""
    from climate_sim_tpu.config import config_to_dict, load_yaml_dict

    cfg = SimConfig()
    cfg.nx, cfg.ny = 96, 64
    cfg.D, cfg.vx = 0.2, -0.5
    cfg.dt, cfg.steps, cfg.out_every = 0.05, 40, 10
    cfg.bc.left = cfg.bc.right = BCType.PERIODIC
    cfg.bc.top = BCType.NEUMANN
    cfg.output_dir = "/tmp/rt"
    cfg.output_prefix = "exp2"
    cfg.output_enable = False
    cfg.write_final = True
    cfg.ic.A = 2.5
    cfg.mesh.x = 4  # y stays None (auto)
    cfg.precision = "bf16"
    cfg.validate()

    rt = load_yaml_dict(config_to_dict(cfg))
    assert rt == cfg

    # Defaults round-trip too (None output_path / mesh axes stay None).
    assert load_yaml_dict(config_to_dict(SimConfig())) == SimConfig()


@pytest.mark.parametrize("form", ["yaml", "cli", "cli_space", "constructor"])
@pytest.mark.parametrize("option,value", [
    ("kernel", "pallas"), ("kernel", "jnp"),
    ("halo_overlap", "true"), ("steps_per_pass", "16"),
])
def test_removed_option_rejected(tmp_path, form, option, value):
    """The options of the removed Pallas kernels fail loudly, naming the
    removal, wherever they are set — never silently ignored."""
    if form == "constructor":
        with pytest.raises(TypeError, match=option):
            SimConfig(**{option: value})
        return
    if form == "yaml":
        y = tmp_path / "c.yaml"
        y.write_text(f"grid: {{ nx: 32 }}\n{option}: {value}\n")
        args, path = [], str(y)
    else:
        args = ([f"--{option}={value}"] if form == "cli"
                else [f"--{option}", value])
        path = None
    with pytest.raises(ValueError, match=f"option '{option}' was removed"):
        merged_config(path, args)
