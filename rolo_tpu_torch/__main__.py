"""Command-line entry point: `python -m rolo_tpu_torch bench`, the port's
counterpart of `python -m rolo_tpu bench`. Other subcommands of the JAX
CLI (run, sim) are not ported yet."""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rolo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("bench", help="registration benchmark on one GPU (one JSON line)")
    args = ap.parse_args(argv)
    if args.cmd == "bench":
        from . import bench

        return bench.main()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
