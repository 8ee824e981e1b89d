"""CLI: ``python -m paddle_tpu_torch.mesh --selftest`` (the mesh layer's
cases in a gloo world of CPU ranks it spawns) and ``--describe AXES``
(print a spec's axes/size and the stock rule sets' assignments for a few
representative names)."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.mesh")
    ap.add_argument("--selftest", action="store_true",
                    help="run the mesh selftest in a spawned gloo world")
    ap.add_argument("--describe", metavar="AXES", default=None,
                    help="parse 'dp=2,tp=4' and print the mesh + stock "
                         "rule assignments")
    args = ap.parse_args(argv)

    if args.describe:
        from . import MeshSpec, decoder_rules, transformer_rules

        ms = MeshSpec.parse(args.describe)
        print(f"mesh: {ms} (devices: {ms.size})")
        tr = transformer_rules()
        dr = decoder_rules()
        for name, ndim in (("enc0.self.q.w", 2), ("enc0.self.out.w", 2),
                           ("enc0.ff1.w", 2), ("enc0.a.ln.scale", 1)):
            print(f"  train {name:24s} -> {tr.spec_for(name, ndim)}")
        for name, ndim in (("layer0/wk", 2), ("layer0/wo", 2),
                           ("tok_emb", 2), ("lnf/0", 1)):
            print(f"  serve {name:24s} -> {dr.spec_for(name, ndim)}")
        return 0

    if args.selftest:
        from .selftest import run_selftest

        return 1 if run_selftest() else 0

    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
