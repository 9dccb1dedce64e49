"""Command-line entry point.

Usage parity with the reference binary (reference: src/main.cpp:30-40):

    python -m climate_sim_tpu [run] --config=cfg.yaml --nx=1024 --dt 0.05 ...

accepts ``--config=<yaml>`` / ``--config <yaml>`` plus any ``--key=value`` or
``--key value`` overrides understood by the config system.  The JAX platform
follows ``JAX_PLATFORMS`` (e.g. ``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from ..config import extract_config_path, merged_config
from .compile_cache import enable_compile_cache
from .driver import run_simulation


def main(argv: Optional[Sequence[str]] = None) -> int:
    args: List[str] = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "run":
        args = args[1:]
    # -h/--help and --version are honored ANYWHERE in argv (not only
    # first): the override parser is reference-permissive about unknown
    # flags, so a trailing --help must not be swallowed into a full run.
    if any(a in ("-h", "--help") for a in args):
        print(__doc__)
        return 0
    if "--version" in args:
        from .. import __version__

        print(f"climate-sim-tpu {__version__}")
        return 0

    try:
        cfg_path = extract_config_path(args)
        cfg = merged_config(cfg_path, args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    enable_compile_cache()
    try:
        run_simulation(cfg)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
