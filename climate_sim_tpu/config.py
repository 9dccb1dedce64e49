"""Configuration system: dataclasses + YAML loader + CLI overrides.

JAX re-design of the reference config layer (reference: include/io.hpp:10-68,
src/io.cpp:30-376).  Behavioral parity:

* defaults match SimConfig defaults (io.hpp:21-39),
* YAML accepts nested blocks ``grid/physics/time/bc/output/ic`` *or* flat keys
  (io.cpp:88-147),
* ``bc:`` may be a scalar (applies to all four sides, io.cpp:127-129) or a
  per-side map (io.cpp:131-138),
* CLI overrides accept both ``--key=value`` and ``--key value`` forms
  (io.cpp:174-217) for the same key set (io.cpp:219-307),
* precedence is defaults < YAML < CLI (io.cpp:363-376),
* ``validate()`` raises on non-positive nx/ny/dx/dy/dt/steps and out_every < 1
  (io.cpp:58-69),
* BC aliases: dirichlet|fixed, neumann|noflux|zero-flux, periodic|period,
  case-insensitive (io.cpp:35-44).

Deliberate fixes over the reference (see docs/decisions.md):

* ``ic.file`` and ``ic.params.{...}`` spellings from configs/dev.yaml are
  accepted (the reference silently ignores them, io.cpp:149-167 vs
  configs/dev.yaml:13-18),
* ``--ic.var`` is actually applied (the reference parses it into CLIOverrides
  but never merges it),
* extras with no reference analogue (precision, mesh, profiling) live in
  their own keys and default to sensible values so reference configs work
  verbatim,
* the YAML reader is in-tree (:func:`parse_yaml`): it covers the subset the
  schema uses, so the package needs nothing beyond numpy and JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


class BCType(enum.Enum):
    """Boundary-condition type for one side (reference: include/boundary.hpp:5)."""

    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    PERIODIC = "periodic"


_BC_ALIASES = {
    "dirichlet": BCType.DIRICHLET,
    "fixed": BCType.DIRICHLET,
    "neumann": BCType.NEUMANN,
    "noflux": BCType.NEUMANN,
    "zero-flux": BCType.NEUMANN,
    "periodic": BCType.PERIODIC,
    "period": BCType.PERIODIC,
}


def bc_from_string(s: str) -> BCType:
    """Parse a BC name with the reference's aliases (io.cpp:35-44)."""
    try:
        return _BC_ALIASES[s.strip().lower()]
    except KeyError:
        raise ValueError(f"Unknown BC type: {s}") from None


def bc_to_string(bc: BCType) -> str:
    return bc.value


@dataclass
class BCConfig:
    """Per-side boundary conditions (reference: include/boundary.hpp:7-12)."""

    left: BCType = BCType.DIRICHLET
    right: BCType = BCType.DIRICHLET
    bottom: BCType = BCType.DIRICHLET
    top: BCType = BCType.DIRICHLET

    def as_tuple(self) -> Tuple[BCType, BCType, BCType, BCType]:
        return (self.left, self.right, self.bottom, self.top)

    def describe(self) -> str:
        """The exact string written to NetCDF metadata (io.cpp:445-447)."""
        return (
            f"left={bc_to_string(self.left)} right={bc_to_string(self.right)}"
            f" bottom={bc_to_string(self.bottom)} top={bc_to_string(self.top)}"
        )


@dataclass
class ICConfig:
    """Initial-condition config (reference: include/io.hpp:10-19)."""

    mode: str = "preset"
    preset: str = "gaussian_hotspot"
    A: float = 1.0
    sigma_frac: float = 0.05
    xc_frac: float = 0.5
    yc_frac: float = 0.5
    path: str = ""
    var: str = "u"


@dataclass
class MeshConfig:
    """Device-mesh layout.  ``None`` axes are chosen automatically with a
    near-square factorization (the ``MPI_Dims_create`` analogue,
    reference: src/decomp.cpp:13)."""

    x: Optional[int] = None
    y: Optional[int] = None
    enable: bool = True  # shard across all local devices when > 1


@dataclass
class SimConfig:
    """Full simulation config (reference: include/io.hpp:21-39)."""

    nx: int = 256
    ny: int = 256
    dx: float = 1.0
    dy: float = 1.0

    D: float = 0.0
    vx: float = 0.0
    vy: float = 0.0

    dt: float = 0.1
    steps: int = 100
    out_every: int = 50

    bc: BCConfig = field(default_factory=BCConfig)

    output_prefix: str = "snap"
    # Fix over the reference: main.cpp:87 hardcodes "outputs/snapshots.nc" and
    # ignores output_prefix.  We keep the same default path but honor an
    # explicit output.path when given.
    output_path: Optional[str] = None
    output_dir: str = "outputs"
    output_enable: bool = True  # false: timing-only runs write no snapshots
    write_final: bool = False  # opt-in post-loop snapshot (decision log #5)

    ic: ICConfig = field(default_factory=ICConfig)

    # --- extensions (no reference analogue) ---
    precision: str = "f32"  # f32 | f64 | bf16 (storage dtype)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Reproduce the reference's actual periodic-BC behavior (a silent no-op
    # whose ghost cells stay 0 forever, i.e. numerically Dirichlet(0);
    # reference: boundary.cpp:23-53 has no Periodic branch and decomp.cpp:14
    # creates a non-periodic Cartesian communicator).
    strict_reference_compat: bool = False
    diagnostics_every: int = 0  # 0 = off; else print min/max/mean/L2 cadence
    debug_nans: bool = False
    profile_dir: str = ""  # non-empty: capture a jax.profiler trace there
    max_devices: int = 0  # 0 = all visible devices; else use the first N
    # Multi-host: jax.distributed.initialize() before backend init.  "auto"
    # passes no arguments (the cluster environment supplies them);
    # otherwise "coordinator:port,num_processes,process_id".
    distributed: str = ""

    def validate(self) -> None:
        """Raise on invalid values (reference: io.cpp:58-69)."""
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError("nx/ny must be > 0")
        if self.dx <= 0 or self.dy <= 0:
            raise ValueError("dx/dy must be > 0")
        if self.dt <= 0:
            raise ValueError("dt must be > 0")
        if self.steps <= 0:
            raise ValueError("steps must be > 0")
        if self.out_every < 1:
            raise ValueError("out_every must be >= 1")
        if self.precision not in ("f32", "f64", "bf16"):
            raise ValueError(f"precision must be f32|f64|bf16, got {self.precision}")
        if self.max_devices < 0:
            raise ValueError("max_devices must be >= 0 (0 = all devices)")
        if (self.mesh.x is not None and self.mesh.x < 1) or (
            self.mesh.y is not None and self.mesh.y < 1
        ):
            raise ValueError("mesh.x/mesh.y must be >= 1 when set")

    def resolved_output_path(self) -> str:
        """Snapshot file path.  The reference hardcodes outputs/snapshots.nc
        and ignores output_prefix entirely (main.cpp:87); we keep that
        default but honor an explicit path or a non-default prefix
        (decision log #3)."""
        if self.output_path:
            return self.output_path
        if self.output_prefix and self.output_prefix != "snap":
            return f"{self.output_dir}/{self.output_prefix}.nc"
        return f"{self.output_dir}/snapshots.nc"


def _load_bc_node(cfg: SimConfig, node: Any) -> None:
    if isinstance(node, str):
        b = bc_from_string(node)
        cfg.bc.left = cfg.bc.right = cfg.bc.bottom = cfg.bc.top = b
    elif isinstance(node, dict):
        for side in ("left", "right", "bottom", "top"):
            if side in node:
                setattr(cfg.bc, side, bc_from_string(str(node[side])))
    else:
        raise ValueError(f"bad bc node: {node!r}")


def _load_ic_node(cfg: SimConfig, node: Dict[str, Any]) -> None:
    ic = cfg.ic
    if "mode" in node:
        ic.mode = str(node["mode"])
    if "preset" in node:
        ic.preset = str(node["preset"])
    # Accept both flat keys (the reference loader, io.cpp:149-167) and the
    # nested `params:` block that configs/dev.yaml actually uses.
    srcs = [node]
    if isinstance(node.get("params"), dict):
        srcs.append(node["params"])
    for src in srcs:
        for k in ("A", "sigma_frac", "xc_frac", "yc_frac"):
            if k in src:
                setattr(ic, k, float(src[k]))
    if "path" in node:
        ic.path = str(node["path"])
    elif "file" in node:  # dev.yaml spelling
        ic.path = str(node["file"])
    if "var" in node:
        ic.var = str(node["var"])


def _load_mesh_node(cfg: SimConfig, node: Any) -> None:
    if isinstance(node, dict):
        # None means "unset" (it is what config_to_dict emits for the
        # defaults), not a request for mesh shape 0.
        if node.get("x") is not None:
            cfg.mesh.x = int(node["x"])
        if node.get("y") is not None:
            cfg.mesh.y = int(node["y"])
        if "enable" in node:
            cfg.mesh.enable = bool(node["enable"])


# --------------------------------------------------------------- YAML subset
#
# The config schema needs nested block mappings, one-line flow mappings,
# comments and scalars, so the reader covers exactly that: no sequences,
# anchors, tags or multi-line scalars.  Anything outside the subset raises
# instead of being misread.  Plain scalars resolve like YAML 1.1 (PyYAML's
# ``safe_load``): null/~/empty, the true/false/yes/no/on/off booleans, ints
# and floats; everything else is a string.  One deliberate difference: an
# exponent without a dot (``1e-3``) is a float here, a string in YAML 1.1 —
# the loader converts numeric keys with ``float()`` either way.

_NULLS = ("", "~", "null", "Null", "NULL")
_TRUES = ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")
_FALSES = ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_HEX_RE = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT_RE = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+]?[0-9]+)?$"
    r"|[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+$"
)
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
            "0": "\0", " ": " "}


class YAMLError(ValueError):
    """A config file outside the supported YAML subset, or malformed."""


def _resolve_plain(text: str) -> Any:
    if text in _NULLS:
        return None
    if text in _TRUES:
        return True
    if text in _FALSES:
        return False
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _HEX_RE.match(text):
        return int(text.replace("_", ""), 16)
    if _FLOAT_RE.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    low = text.lower()
    if low in (".inf", "+.inf", "-.inf"):
        return float("-inf") if low.startswith("-") else float("inf")
    if low == ".nan":
        return float("nan")
    return text


class _Scanner:
    """Cursor over one logical line's value text (after ``key:``)."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def fail(self, msg: str):
        raise YAMLError(f"{self.where}: {msg}")

    def skip_ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                self.fail("unterminated quoted scalar")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                elif esc == "u" and re.match(r"[0-9a-fA-F]{4}$",
                                             self.s[self.i + 2:self.i + 6]):
                    out.append(chr(int(self.s[self.i + 2:self.i + 6], 16)))
                    self.i += 6
                else:
                    self.fail(f"unsupported escape \\{esc}")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if flow and c in ",{}[]":
                break
            if c == ":" and (flow or self.i + 1 == len(self.s)
                             or self.s[self.i + 1] in " \t"):
                if flow:
                    break
                self.fail("nested mapping on one line needs a flow mapping {...}")
            self.i += 1
        return self.s[start:self.i].strip()

    def value(self, flow: bool) -> Any:
        self.skip_ws()
        c = self.peek()
        if c == "{":
            return self.flow_mapping()
        if c in "[]":
            self.fail("sequences are not part of the config schema")
        if c in "&*!|>%@`":
            self.fail(f"unsupported YAML construct {c!r}")
        if c in "'\"":
            return self.quoted()
        return _resolve_plain(self.plain(flow))

    def key(self, flow: bool) -> str:
        self.skip_ws()
        c = self.peek()
        if c in "'\"":
            k = self.quoted()
        else:
            k = self.plain(flow=True)
            if not k:
                self.fail("empty mapping key")
        self.skip_ws()
        if self.peek() != ":":
            self.fail(f"expected ':' after key {k!r}")
        self.i += 1
        return k

    def flow_mapping(self) -> Dict[str, Any]:
        self.i += 1  # '{'
        out: Dict[str, Any] = {}
        self.skip_ws()
        if self.peek() == "}":
            self.i += 1
            return out
        while True:
            k = self.key(flow=True)
            if k in out:
                self.fail(f"duplicate key {k!r}")
            out[k] = self.value(flow=True)
            self.skip_ws()
            c = self.peek()
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                self.fail("expected ',' or '}' in flow mapping")
            self.skip_ws()
            if self.peek() == "}":  # trailing comma
                self.i += 1
                return out

    def end(self) -> None:
        self.skip_ws()
        if self.i != len(self.s):
            self.fail(f"unexpected text {self.s[self.i:]!r}")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = ""
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1  # the escaped character cannot close the quote
            elif c == quote:
                quote = ""
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def parse_yaml(text: str) -> Any:
    """Parse the config subset of YAML.  Returns a nested dict, or None for
    an empty document (like ``yaml.safe_load``)."""
    lines: List[Tuple[int, str, str]] = []  # (indent, content, where)
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip() or (not lines and body.strip() == "---"):
            continue
        if body.strip() == "...":
            break
        lead = body[: len(body) - len(body.lstrip())]
        if "\t" in lead:
            raise YAMLError(f"line {n}: tabs are not allowed in indentation")
        if body.lstrip().startswith("- ") or body.strip() == "-":
            raise YAMLError(
                f"line {n}: sequences are not part of the config schema")
        lines.append((len(lead), body.strip(), f"line {n}"))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1].startswith("{"):
        sc = _Scanner(lines[0][1], lines[0][2])
        out = sc.value(flow=True)
        sc.end()
        return out

    def block(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines):
            ind, content, where = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"{where}: unexpected indentation")
            sc = _Scanner(content, where)
            k = sc.key(flow=False)
            if k in out:
                sc.fail(f"duplicate key {k!r}")
            sc.skip_ws()
            i += 1
            if sc.peek() == "":
                if i < len(lines) and lines[i][0] > ind:
                    out[k], i = block(i, lines[i][0])
                else:
                    out[k] = None  # an empty block
                continue
            out[k] = sc.value(flow=False)
            sc.end()
        return out, i

    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise YAMLError(f"{lines[i][2]}: indentation below the document's")
    return out


def load_yaml_file(path: str, validate: bool = True) -> SimConfig:
    """Load a YAML config accepting nested blocks or flat keys (io.cpp:84-171).

    ``validate=False`` defers validation — used by :func:`merged_config` so a
    CLI flag can override an invalid YAML value before the check runs.
    """
    with open(path, "r") as f:
        root = parse_yaml(f.read()) or {}
    if not isinstance(root, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return load_yaml_dict(root, validate=validate)


def load_yaml_dict(root: Dict[str, Any], validate: bool = True) -> SimConfig:
    for key in root:
        _reject_removed(key)
    cfg = SimConfig()

    def node(name):
        # A present-but-empty block (e.g. "grid:" with all entries commented
        # out) parses to None; treat it as absent like yaml-cpp's null nodes.
        v = root.get(name)
        return v if isinstance(v, dict) else root

    grid = node("grid")
    for k in ("nx", "ny"):
        if k in grid:
            cfg.__setattr__(k, int(grid[k]))
    for k in ("dx", "dy"):
        if k in grid:
            cfg.__setattr__(k, float(grid[k]))

    phys = node("physics")
    for k in ("D", "vx", "vy"):
        if k in phys:
            cfg.__setattr__(k, float(phys[k]))

    time = node("time")
    if "dt" in time:
        cfg.dt = float(time["dt"])
    if "steps" in time:
        cfg.steps = int(time["steps"])
    if "out_every" in time:
        cfg.out_every = int(time["out_every"])

    if "bc" in root:
        _load_bc_node(cfg, root["bc"])

    if "output" in root:
        out = root["output"]
        if isinstance(out, dict):
            if "prefix" in out:
                cfg.output_prefix = str(out["prefix"])
            if "path" in out:
                cfg.output_path = str(out["path"])
            if "dir" in out:
                cfg.output_dir = str(out["dir"])
            if "write_final" in out:
                cfg.write_final = bool(out["write_final"])
            if "enable" in out:
                cfg.output_enable = bool(out["enable"])
    else:
        # Flat spellings — config_to_dict emits these, so its output
        # round-trips through this loader.
        if "output_prefix" in root:
            cfg.output_prefix = str(root["output_prefix"])
        if root.get("output_path") is not None:
            cfg.output_path = str(root["output_path"])
        if "output_dir" in root:
            cfg.output_dir = str(root["output_dir"])
        if "output_enable" in root:
            cfg.output_enable = bool(root["output_enable"])
        if "write_final" in root:
            cfg.write_final = bool(root["write_final"])

    if "ic" in root and isinstance(root["ic"], dict):
        _load_ic_node(cfg, root["ic"])

    # Extensions with no reference analogue
    if "precision" in root:
        cfg.precision = str(root["precision"])
    if "mesh" in root:
        _load_mesh_node(cfg, root["mesh"])
    if "strict_reference_compat" in root:
        cfg.strict_reference_compat = bool(root["strict_reference_compat"])
    if "diagnostics_every" in root:
        cfg.diagnostics_every = int(root["diagnostics_every"])
    if "debug_nans" in root:
        cfg.debug_nans = bool(root["debug_nans"])
    if "profile_dir" in root:
        cfg.profile_dir = str(root["profile_dir"])
    if "max_devices" in root:
        cfg.max_devices = int(root["max_devices"])
    if "distributed" in root:
        cfg.distributed = str(root["distributed"])

    # merged_config defers validation until after CLI overrides, so a CLI
    # flag can override an invalid YAML value (io.cpp:363-376 precedence);
    # direct callers get validated configs by default.
    if validate:
        cfg.validate()
    return cfg


# Keys the CLI override parser understands, with their coercion functions.
# Mirrors the reference's key set (io.cpp:219-307) plus the extensions.
_INT_KEYS = (
    "nx", "ny", "steps", "out_every", "mesh.x", "mesh.y", "diagnostics_every",
    "max_devices",
)
_FLOAT_KEYS = (
    "dx",
    "dy",
    "D",
    "vx",
    "vy",
    "dt",
    "ic.A",
    "ic.sigma_frac",
    "ic.xc_frac",
    "ic.yc_frac",
)
_STR_KEYS = (
    "output.prefix",
    "output_prefix",
    "output.path",
    "output.dir",
    "ic.mode",
    "ic.preset",
    "ic.path",
    "ic.var",
    "precision",
    "profile_dir",
    "distributed",
)
_BC_KEYS = ("bc.left", "bc.right", "bc.bottom", "bc.top", "bc")
_BOOL_KEYS = (
    "strict_reference_compat", "write_final", "debug_nans", "mesh.enable",
    "output.enable",
)

# Options that selected the removed Pallas multi-step kernels.  Setting one
# fails loudly instead of being ignored, so an old config cannot silently
# run something other than what it names.
REMOVED_OPTIONS = {
    "kernel": "the Pallas kernels were removed; every run uses the"
    " jax.numpy stencil compiled by XLA",
    "halo_overlap": "the overlapped halo exchange went with the Pallas"
    " multi-step kernels; the sharded path exchanges halos every step",
    "steps_per_pass": "multi-step kernel passes went with the Pallas"
    " kernels; every run advances one step per halo exchange",
}


def _reject_removed(key: str) -> None:
    if key in REMOVED_OPTIONS:
        raise ValueError(f"option '{key}' was removed: {REMOVED_OPTIONS[key]}")


def parse_cli_overrides(args: Sequence[str]) -> Dict[str, Any]:
    """Parse ``--key=value`` / ``--key value`` overrides (io.cpp:180-310).

    Returns a flat ``{key: coerced value}`` dict.  Unknown ``--flags`` are
    ignored, matching the reference's permissive loop — but a one-line
    stderr warning is printed per ignored flag, so a typo like
    ``--step=100`` cannot silently run 100 default steps.  ``--config``
    is consumed separately (:func:`extract_config_path`) and never warns.
    """
    out: Dict[str, Any] = {}
    argv = list(args)
    i = 0

    def coerce(key: str, raw: str) -> Any:
        if key in _INT_KEYS:
            return int(raw)
        if key in _FLOAT_KEYS:
            return float(raw)
        if key in _BC_KEYS:
            return bc_from_string(raw)
        if key in _BOOL_KEYS:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return raw

    known = (
        set(_INT_KEYS) | set(_FLOAT_KEYS) | set(_STR_KEYS) | set(_BC_KEYS)
        | set(_BOOL_KEYS)
    )

    # Flags handled elsewhere in the CLI stack: --config by
    # extract_config_path, help/version by runtime/cli.py.
    _external = {"config", "help", "version"}
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            body = a[2:]
            _reject_removed(body.split("=", 1)[0])
            if "=" in body:
                key, raw = body.split("=", 1)
                if key in known:
                    out[key] = coerce(key, raw)
                elif key not in _external:
                    print(f"warning: ignored unknown flag --{key}",
                          file=sys.stderr)
            else:
                key = body
                if key in known and i + 1 < len(argv):
                    out[key] = coerce(key, argv[i + 1])
                    i += 1
                elif key in known:
                    print(f"warning: ignored flag --{key} (missing value)",
                          file=sys.stderr)
                elif key not in _external:
                    print(f"warning: ignored unknown flag --{key}",
                          file=sys.stderr)
        i += 1
    return out


def apply_overrides(cfg: SimConfig, overrides: Dict[str, Any]) -> None:
    """Apply flat CLI overrides onto a config (io.cpp:312-360)."""
    simple = {
        "nx", "ny", "dx", "dy", "D", "vx", "vy", "dt", "steps", "out_every",
        "output_prefix", "precision", "strict_reference_compat",
        "write_final", "debug_nans", "diagnostics_every", "profile_dir",
        "distributed", "max_devices",
    }
    for key, val in overrides.items():
        if key in simple:
            setattr(cfg, key, val)
        elif key == "bc":
            cfg.bc.left = cfg.bc.right = cfg.bc.bottom = cfg.bc.top = val
        elif key.startswith("bc."):
            setattr(cfg.bc, key[3:], val)
        elif key == "output.prefix":
            cfg.output_prefix = val
        elif key == "output.path":
            cfg.output_path = val
        elif key == "output.dir":
            cfg.output_dir = val
        elif key == "output.enable":
            cfg.output_enable = val
        elif key.startswith("ic."):
            setattr(cfg.ic, key[3:], val)
        elif key == "mesh.x":
            cfg.mesh.x = val
        elif key == "mesh.y":
            cfg.mesh.y = val
        elif key == "mesh.enable":
            cfg.mesh.enable = val


def extract_config_path(args: Sequence[str]) -> Optional[str]:
    """Find ``--config=path`` or ``--config path`` (reference: main.cpp:30-38)."""
    argv = list(args)
    path = None
    for i, a in enumerate(argv):
        if a.startswith("--config="):
            path = a[len("--config="):]
        elif a == "--config" and i + 1 < len(argv):
            path = argv[i + 1]
    return path


def merged_config(yaml_path: Optional[str], cli_args: Sequence[str]) -> SimConfig:
    """defaults < YAML < CLI, then validate (reference: io.cpp:363-376)."""
    if yaml_path:
        cfg = load_yaml_file(yaml_path, validate=False)
    else:
        cfg = SimConfig()
    apply_overrides(cfg, parse_cli_overrides(cli_args))
    cfg.validate()
    return cfg


def config_to_dict(cfg: SimConfig) -> Dict[str, Any]:
    """Round-trippable dict form (for logging / metadata)."""
    d = dataclasses.asdict(cfg)
    d["bc"] = {s: bc_to_string(getattr(cfg.bc, s)) for s in ("left", "right", "bottom", "top")}
    return d
