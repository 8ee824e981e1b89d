"""Operator entry point of the port's serving path (the counterpart of
``python -m paddle_tpu.serving``):

    python -m paddle_tpu_torch.serving --serve --load resnet50=DIR \\
        [--host 127.0.0.1] [--port 0] [--device cuda]

starts a ``ServingServer`` on ``--device`` (default: the card; it raises
without one — pass ``--device cpu`` to serve on the CPU), loads every
``--load NAME=DIR`` save_inference_model directory (warming each bucket
of the default ladder), prints the endpoint and serves until ctrl-c.
Clients call it with ``ServingClient((host, port)).infer(NAME, feeds)``.

``--selftest`` is the JAX package's in-process end-to-end check; it
drives StableHLO exports, which are not ported, so here it says so and
exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
import time

SELFTEST_NOT_PORTED = (
    "paddle_tpu_torch.serving --selftest is not yet ported: the JAX "
    "package's selftest drives StableHLO exports, which wait for a later "
    "slice of the port. Use `python3 chip_smoke.py` on a card, or the "
    "tests/test_torch_*.py suites on the CPU.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.serving")
    ap.add_argument("--selftest", action="store_true",
                    help="(not yet ported) the in-process selftest")
    ap.add_argument("--serve", action="store_true",
                    help="start a ServingServer")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--load", action="append", default=[],
                    metavar="NAME=DIR",
                    help="model(s) to load at startup (repeatable)")
    args = ap.parse_args(argv)

    if args.selftest:
        print(SELFTEST_NOT_PORTED, file=sys.stderr)
        return 2
    if not args.serve:
        ap.error("pass --serve (or --selftest)")
    from . import InferenceEngine, ServingServer

    srv = ServingServer(device=args.device)
    host, port = srv.serve(args.host, args.port)
    for spec in args.load:
        name, _, dirname = spec.partition("=")
        if not dirname:
            print(f"bad --load {spec!r} (want NAME=DIR)", file=sys.stderr)
            srv.shutdown()
            return 2
        eng = srv.registry.deploy(
            name, lambda d=dirname, n=name:
                InferenceEngine.from_inference_dir(d, name=n,
                                                   device=srv.device))
        print(f"loaded {name} v{eng.version} from {dirname} "
              f"(buckets {eng.buckets})", flush=True)
    print(f"serving on {host}:{port} (ctrl-c to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
