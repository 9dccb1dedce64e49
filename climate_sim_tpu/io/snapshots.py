"""Snapshot output with the reference's frozen NetCDF schema.

Schema (reference: src/io.cpp:378-448): dims ``time`` (UNLIMITED), ``y``
(ny_global), ``x`` (nx_global); one NC_DOUBLE variable ``u(time, y, x)``;
global text attributes ``description``, ``grid`` ("NX x NY"), ``dt``,
``steps``, ``D``, ``velocity`` ("(vx,vy)"), ``boundary_conditions``
("left=.. right=.. bottom=.. top=..").  Numbers are formatted like C++
``std::to_string`` (fixed, 6 decimals) so downstream tooling sees identical
strings.  The file is CDF-5 (NC_64BIT_DATA), matching
``ncmpi_create(NC_CLOBBER | NC_64BIT_DATA)`` (io.cpp:386).

The reference's Python visualization package reads these files unchanged.

When the native C++ I/O runtime is available (``climate_sim_tpu.io.native``),
record appends are handed to a background writer thread so snapshot encoding
and disk I/O overlap device compute — the analogue of PnetCDF's
nonblocking collective writes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import SimConfig
from .netcdf import NetCDFWriter


def _cxx_to_string(v: float) -> str:
    """Format like C++ std::to_string(double): fixed, 6 decimals."""
    return f"{v:.6f}"


def metadata_attrs(cfg: SimConfig) -> dict:
    """The exact global-attribute set (reference: io.cpp:428-448)."""
    return {
        "description": "climate-sim-tpu",
        "grid": f"{cfg.nx} x {cfg.ny}",
        "dt": _cxx_to_string(cfg.dt),
        "steps": str(cfg.steps),
        "D": _cxx_to_string(cfg.D),
        "velocity": f"({_cxx_to_string(cfg.vx)},{_cxx_to_string(cfg.vy)})",
        "boundary_conditions": cfg.bc.describe(),
    }


def _define_schema(w: NetCDFWriter, cfg: SimConfig) -> None:
    """The frozen ``u(time, y, x)`` schema + global attrs (io.cpp:378-448)."""
    w.def_dim("time", None)
    w.def_dim("y", cfg.ny)
    w.def_dim("x", cfg.nx)
    w.def_var("u", np.float64, ("time", "y", "x"))
    for k, v in metadata_attrs(cfg).items():
        w.put_gatt(k, v)
    w.enddef()


def _open_backend(path: str, cfg: SimConfig, create: bool, use_native: bool):
    """Open (native_writer, python_writer): the C++ async writer when its
    shared library builds/loads, else the pure-Python codec (byte-identical
    output).  The fallback is logged once — a silently-degraded run would
    lose the async-overlap performance the native path exists for with no
    way to notice short of profiling."""
    if create:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    if use_native:
        try:
            from .native import NativeSnapshotWriter

            return (
                NativeSnapshotWriter(
                    path, cfg, metadata_attrs(cfg), create=create
                ),
                None,
            )
        except Exception as e:
            import sys

            print(
                f"[climate_sim_tpu] native snapshot writer unavailable "
                f"({type(e).__name__}: {e}); using the Python codec",
                file=sys.stderr,
            )

    w = NetCDFWriter(path, version=5, create=create)
    _define_schema(w, cfg)
    return None, w


class ShardedSnapshotWriter:
    """Per-process parallel snapshot writes: every process writes ONLY the
    rows of its locally-addressable shards, at deterministic record offsets.

    This is the analogue of the reference's collective per-rank
    hyperslab writes (``ncmpi_put_vara_double_all`` at
    ``start={step, y_off, x_off}``, io.cpp:402-424): all processes open the
    same file on a shared filesystem; the creating process (the controller)
    writes the header and maintains numrecs; everyone else attaches with
    ``create=False`` (which byte-verifies the header) and pwrites disjoint
    regions.  No process ever materializes the (ny, nx) global array, so
    host memory stays O(shard) and writes proceed in parallel.

    Caller contract: construct with ``create=True`` on exactly one process,
    barrier, then ``create=False`` elsewhere (the driver does this).

    When the native C++ runtime is available, region appends are handed to
    its background writer thread (``use_native=True``), so the byte-swap and
    disk writes overlap device compute on every process — the full analogue
    of PnetCDF's nonblocking collective writes.  Fallback is the pure-Python
    codec (byte-identical output).
    """

    def __init__(self, path: str, cfg: SimConfig, create: bool,
                 use_native: bool = True):
        self.path = path
        self.cfg = cfg
        self._native, self._w = _open_backend(path, cfg, create, use_native)
        self._next_index = 0

    @property
    def time_index(self) -> int:
        return self._next_index

    def write_shards(self, u, step_index: Optional[int] = None) -> int:
        """Append this process's shards of one snapshot; returns the record
        index.  ``u`` is a (possibly multi-host) sharded ``jax.Array`` of the
        global interior field."""
        idx = self._next_index if step_index is None else step_index
        for shard in u.addressable_shards:
            if shard.replica_id:  # replicated copy: rows already covered
                continue
            ys, xs = shard.index
            block = np.asarray(shard.data, dtype=np.float64)
            if self._native is not None:
                self._native.append_region(idx, ys.start or 0, xs.start or 0, block)
            else:
                self._w.put_rec_region(
                    "u", idx, (ys.start or 0, xs.start or 0), block
                )
        self._next_index = max(self._next_index, idx + 1)
        return idx

    def sync(self) -> None:
        if self._native is not None:
            self._native.flush()
        else:
            self._w.sync()

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        else:
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SnapshotWriter:
    """Writes ``u(time, y, x)`` snapshots; one instance per run.

    ``use_native=True`` offloads appends to the C++ async writer when the
    shared library is available, falling back to the pure-Python codec.
    """

    def __init__(self, path: str, cfg: SimConfig, use_native: bool = True):
        self.path = path
        self.cfg = cfg
        self._native, self._w = _open_backend(path, cfg, True, use_native)
        self._next_index = 0

    @property
    def time_index(self) -> int:
        return self._next_index

    def write(self, u, step_index: Optional[int] = None) -> int:
        """Append one snapshot (converted to float64, matching NC_DOUBLE).

        Returns the time index written.  Mirrors write_field_netcdf's
        halo-stripped interior hyperslab write (io.cpp:402-418) — here ``u``
        is already the interior global field.
        """
        idx = self._next_index if step_index is None else step_index
        frame = np.asarray(u, dtype=np.float64)
        if frame.shape != (self.cfg.ny, self.cfg.nx):
            raise ValueError(
                f"snapshot shape {frame.shape} != (ny={self.cfg.ny}, nx={self.cfg.nx})"
            )
        if self._native is not None:
            self._native.append(idx, frame)
        else:
            self._w.put_rec("u", idx, frame)
        self._next_index = max(self._next_index, idx + 1)
        return idx

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        elif self._w is not None:
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
