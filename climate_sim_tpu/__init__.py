"""climate_sim_tpu — a 2D climate stencil framework in JAX.

Brand-new JAX/XLA implementation, run on NVIDIA GPUs, with the capabilities of the
C++/MPI reference (antoniorizzoeng/climate-sim-mpi-cpp): explicit FTCS
diffusion + first-order upwind advection of a passive scalar on a 2D
Cartesian grid, per-side Dirichlet/Neumann/periodic BCs, Gaussian/file ICs,
CFL guard, YAML+CLI config, and classic-NetCDF snapshot output readable by
the reference's visualization tooling.

Layers (see SURVEY.md §1-2 for the reference mapping):

* :mod:`climate_sim_tpu.config`   — config system (C8)
* :mod:`climate_sim_tpu.ops`      — numerics kernels (C4-C7, C10)
* :mod:`climate_sim_tpu.parallel` — device mesh + halo exchange (C2, C3)
* :mod:`climate_sim_tpu.io`       — NetCDF codec + snapshots (C9)
* :mod:`climate_sim_tpu.runtime`  — driver + CLI (C11)
"""

from .config import (
    BCConfig,
    BCType,
    ICConfig,
    SimConfig,
    bc_from_string,
    bc_to_string,
    load_yaml_file,
    merged_config,
    parse_cli_overrides,
)
from .ops.stability import safe_dt

__version__ = "0.1.0"

__all__ = [
    "BCConfig",
    "BCType",
    "ICConfig",
    "SimConfig",
    "bc_from_string",
    "bc_to_string",
    "load_yaml_file",
    "merged_config",
    "parse_cli_overrides",
    "safe_dt",
    "__version__",
]
