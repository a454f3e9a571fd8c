"""CLI: run reference .arc cases or the assembly lab.

The role of the reference's per-module executables + ArcaneLauncher
(modules/*/main.cc): `python -m arcanefem_tpu run <case.arc>` dispatches on
the case's codename exactly like the Arcane time-loop registration does.

    python -m arcanefem_tpu run inputs/circle.2D.arc [--f32] [--no-check]
    python -m arcanefem_tpu testlab --box 40 --cross-validate

Both run on the GPU and fail without one; ``JAX_PLATFORMS=cpu`` is the one
way to ask for the CPU instead.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="arcanefem_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a reference .arc case")
    runp.add_argument("case")
    runp.add_argument("--f32", action="store_true",
                      help="solve in float32 (default float64)")
    runp.add_argument("--no-check", action="store_true",
                      help="skip golden-file validation")
    runp.add_argument("--mesh-root", default=None)
    runp.add_argument("--output-dir", default=None,
                      help="write <arcane-post-processing> variables "
                           "as VTKHDF (ParaView) files here")

    sub.add_parser("testlab", add_help=False)

    if argv and argv[0] == "testlab":
        from . import testlab

        return testlab.main(argv[1:])

    args = p.parse_args(argv)

    # f64 (default) is the golden-tolerance gate; the GPU runs it natively
    from .utils import device

    device.setup(cpu=device.cpu_pinned(), x64=not args.f32)

    from .fem.runner import run_case

    res = run_case(
        args.case,
        dtype=np.float32 if args.f32 else np.float64,
        mesh_root=args.mesh_root,
        check=not args.no_check,
        verbose=True,
        output_dir=args.output_dir,
    )
    info = {
        k: v for k, v in vars(res).items()
        if isinstance(v, (int, float, str))
    }
    print(f"done: {type(res).__name__} {info}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
