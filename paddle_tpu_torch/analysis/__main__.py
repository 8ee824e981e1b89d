"""The CLI: run every static-analysis pass over the port's tree and
the real book-example Programs built with the port.

    python -m paddle_tpu_torch.analysis               # all passes
    python -m paddle_tpu_torch.analysis --json        # machine-readable
    python -m paddle_tpu_torch.analysis --selftest    # every code fires
                                                      # on its synthetic
                                                      # bad input
    python -m paddle_tpu_torch.analysis --skip locks  # drop a pass
    python -m paddle_tpu_torch.analysis --no-shapes   # skip V003/V004

Exit status: nonzero iff any ERROR-level diagnostic (or a failing
selftest case). Warnings print but do not fail the run — the gate is
"no errors", matching the executor hook's refusal policy.

The CLI touches no device, on a machine with a card or without: the
verifier runs emitters on ``meta`` tensors and the lints read source.
So there is nothing to pin to the CPU, and this is not a CPU fallback
of any entry point."""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis")
    ap.add_argument("--json", action="store_true",
                    help="emit diagnostics as a JSON document")
    ap.add_argument("--selftest", action="store_true",
                    help="prove every diagnostic code fires on a "
                         "synthetic bad input")
    ap.add_argument("--skip", action="append", default=[],
                    choices=["verify", "locks", "guards", "invariants"],
                    help="skip a pass (repeatable)")
    ap.add_argument("--no-shapes", action="store_true",
                    help="skip the meta-tensor shape/dtype re-check "
                         "(V003/V004)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    args = ap.parse_args(argv)

    from .diagnostics import ERROR
    from .selftest import run_selftest

    if args.selftest:
        results = run_selftest()
        ok = all(fired for _, fired, _ in results)
        if args.json:
            print(json.dumps({
                "selftest": [{"code": c, "fired": f} for c, f, _ in results],
                "ok": ok,
            }, indent=2))
        else:
            for code, fired, _diags in results:
                print(f"  {code}: {'fired' if fired else 'DID NOT FIRE'}")
            print(f"selftest: {len(results)} codes, "
                  f"{'all fired' if ok else 'SOME DID NOT FIRE'}")
        return 0 if ok else 1

    diags = []
    ran = []
    if "verify" not in args.skip:
        from .examples import build_all
        from .verify import verify_program

        ran.append("verify")
        for name, (main_prog, startup) in sorted(build_all().items()):
            for kind, prog in (("main", main_prog), ("startup", startup)):
                for d in verify_program(prog,
                                        check_shapes=not args.no_shapes):
                    d.where = f"{name}/{kind}: {d.where}"
                    diags.append(d)
    if "locks" not in args.skip:
        from .locks import default_lint_paths, lint_paths

        ran.append("locks")
        diags += lint_paths(default_lint_paths(args.root))
    if "guards" not in args.skip:
        from .guards import default_lint_paths as guard_paths
        from .guards import lint_paths as guard_lint

        ran.append("guards")
        diags += guard_lint(guard_paths(args.root))
    if "invariants" not in args.skip:
        from .invariants import check_repo

        ran.append("invariants")
        diags += check_repo(args.root)

    n_err = sum(1 for d in diags if d.severity == ERROR)
    n_warn = len(diags) - n_err
    if args.json:
        print(json.dumps({
            "passes": ran,
            "errors": n_err,
            "warnings": n_warn,
            "diagnostics": [d.to_dict() for d in diags],
        }, indent=2))
    else:
        for d in diags:
            print(d.format())
        print(f"[analysis] passes: {', '.join(ran)} — "
              f"{n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
