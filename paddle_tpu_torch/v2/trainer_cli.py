"""`paddle_trainer`-style CLI over the v2 facade (reference
paddle/trainer/TrainerMain.cpp:32-53 + the legacy workflow: a Python config
file declares the network, the binary drives passes, logging, checkpoints).

Usage:
    python -m paddle_tpu_torch.v2.trainer_cli --config my_config.py \
        --num-passes 3 --save-dir ./ckpt --log-period 10 [--use_gpu 0]

The config file is plain Python executed at startup. It must define:
    cost          — the v2/fluid cost variable (build the net at module top
                    level, exactly like a trainer_config_helpers config)
    optimizer     — a paddle_tpu_torch.v2.optimizer.* (or fluid optimizer)
    train_reader  — callable yielding minibatches (lists of samples)
and may define:
    test_reader   — callable, evaluated at every pass end
    feeding       — {data_name: sample_index} feed-order map

Device: ``--use_gpu`` is ``paddle.init``'s (``0`` or ``false`` asks for
the CPU); without it, whatever the config's own ``paddle.init`` chose,
else the card. ``--trainer_count`` has no meaning here (parallelism is
the ParallelExecutor's) and is accepted but ignored for config
compatibility.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys


def _load_config(path: str) -> dict:
    cfg = runpy.run_path(path)
    missing = [k for k in ("cost", "optimizer", "train_reader")
               if k not in cfg]
    if missing:
        raise SystemExit(
            f"config {path!r} must define {missing} "
            "(see paddle_tpu_torch/v2/trainer_cli.py docstring)")
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.v2.trainer_cli",
        description="paddle_trainer-style CLI over the v2 facade",
    )
    ap.add_argument("--config", required=True,
                    help="python file declaring cost/optimizer/train_reader")
    ap.add_argument("--num-passes", type=int, default=1)
    ap.add_argument("--save-dir", default=None,
                    help="write params_pass_<n>.tar checkpoints here")
    ap.add_argument("--log-period", type=int, default=20,
                    help="print train cost every N batches")
    # the legacy device flag (paddle.init's use_gpu); trainer_count is
    # accepted but ignored
    ap.add_argument("--use_gpu", "--use-gpu", default=None, nargs="?",
                    const="1")
    ap.add_argument("--trainer_count", "--trainer-count", default=None,
                    nargs="?")
    args = ap.parse_args(argv)

    from .. import v2 as paddle_v2
    from . import event as v2_event

    if args.use_gpu is not None:
        paddle_v2.init(use_gpu=args.use_gpu.lower() not in ("0", "false"))
    cfg = _load_config(args.config)
    cost, optimizer = cfg["cost"], cfg["optimizer"]
    parameters = paddle_v2.create(cost)
    trainer = paddle_v2.SGD(cost=cost, parameters=parameters,
                            update_equation=optimizer)

    test_reader = cfg.get("test_reader")
    feeding = cfg.get("feeding")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    def handler(e):
        if isinstance(e, v2_event.EndIteration):
            # log-period 0 = per-batch logging disabled
            if args.log_period > 0 and e.batch_id % args.log_period == 0:
                print(f"pass {e.pass_id} batch {e.batch_id} "
                      f"cost {e.cost:.6f}", flush=True)
        elif isinstance(e, v2_event.EndPass):
            if test_reader is not None:
                r = trainer.test(reader=test_reader, feeding=feeding)
                print(f"pass {e.pass_id} test cost {r.cost:.6f}", flush=True)
            if args.save_dir:
                p = os.path.join(args.save_dir,
                                 f"params_pass_{e.pass_id}.tar")
                with open(p, "wb") as f:
                    parameters.to_tar(f)
                print(f"saved {p}", flush=True)

    trainer.train(reader=cfg["train_reader"],
                  num_passes=args.num_passes,
                  event_handler=handler,
                  feeding=feeding)
    return 0


if __name__ == "__main__":
    sys.exit(main())
