"""Command-line entry point of the checkpoint subsystem.

    python -m paddle_tpu_torch.checkpoint inspect DIR
        Print the manifest summary: format version, payload, meta,
        and per-tensor dtype/shape/offset/bytes.

    python -m paddle_tpu_torch.checkpoint verify DIR
        Full checksum pass over every segment. Exit-nonzero with the
        OFFENDING TENSOR named on any corruption/truncation — the
        operator probe for "is this artifact deployable".

    python -m paddle_tpu_torch.checkpoint --selftest
        In-process proof on the CPU: bitwise roundtrip, tuple-structure
        restore, named corruption/truncation failures, the torn-write
        crash discipline, decoder-contract validation, and decoder
        save/load logits equality on the port's decoder.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def cmd_inspect(dirname: str) -> int:
    from .format import read_manifest

    m = read_manifest(dirname)
    sharded = "payloads" in m

    def _t_bytes(t):
        if sharded:
            return sum(int(s["nbytes"]) for s in t["segments"])
        return int(t["nbytes"])

    total = sum(_t_bytes(t) for t in m["tensors"])
    print(f"checkpoint {dirname}")
    print(f"  format:  v{m['format']}")
    if sharded:
        print(f"  payloads: {len(m['payloads'])} shard files over axis "
              f"'{m['shard_axis']}' ({total} tensor bytes, "
              f"{len(m['tensors'])} tensors)")
    else:
        print(f"  payload: {m['payload']} ({total} tensor bytes, "
              f"{len(m['tensors'])} tensors)")
    meta = m.get("meta") or {}
    if meta:
        print(f"  meta:    {json.dumps(meta, sort_keys=True)}")
    if m.get("base"):
        print(f"  base:    {m['base']}")
    for t in m["tensors"]:
        if sharded:
            dim = t.get("dim")
            loc = ("replicated" if dim is None
                   else f"dim {dim} over {len(t['segments'])} shards")
        else:
            # delta checkpoints: a base-resident tensor has no offset
            loc = "base" if t.get("base") else f"@{t['offset']}"
        print(f"  {t['name']:<24} {t['dtype']:<10} "
              f"{str(tuple(t['shape'])):<18} {loc} "
              f"({_t_bytes(t)} B)")
    return 0


def cmd_verify(dirname: str) -> int:
    from .format import CheckpointCorruptError, CheckpointError, \
        load_checkpoint_arrays

    try:
        arrays, m = load_checkpoint_arrays(dirname, verify=True)
    except CheckpointCorruptError as e:
        print(f"CORRUPT (tensor '{e.tensor}'): {e}")
        return 1
    except CheckpointError as e:
        print(f"INVALID: {e}")
        return 1
    total = sum(a.nbytes for a in arrays.values())
    what = (f"{len(m['payloads'])} shard payloads"
            if "payloads" in m else m["payload"])
    print(f"OK: {len(arrays)} tensors, {total} bytes, every "
          f"checksum verified ({what})")
    return 0


def run_selftest(verbose: bool = True) -> int:
    import numpy as np

    import torch

    from ..distributed import faults
    from . import (CheckpointCorruptError, CheckpointError,
                   load_checkpoint_arrays, load_checkpoint_tree,
                   load_decoder_checkpoint, read_manifest,
                   save_checkpoint_tree, save_decoder_checkpoint)

    failures = []

    def check(ok, what):
        if verbose:
            print(("  ok  " if ok else "  FAIL") + f" {what}")
        if not ok:
            failures.append(what)

    with tempfile.TemporaryDirectory() as tmp:
        # -- 1. bitwise roundtrip + structure restore --------------------
        rng = np.random.RandomState(0)
        tree = {
            "emb": rng.randn(7, 6).astype(np.float32),
            "ln": (np.ones(6, np.float32), np.zeros(6, np.float32)),
            "ids": np.arange(5, dtype=np.int32),
        }
        d1 = os.path.join(tmp, "ck1")
        save_checkpoint_tree(d1, tree, meta={"step": 3})
        got, manifest = load_checkpoint_tree(d1)
        check(isinstance(got["ln"], tuple), "tuple structure restored")
        check(all(np.array_equal(a, b) for a, b in (
            (got["emb"], tree["emb"]), (got["ln"][0], tree["ln"][0]),
            (got["ids"], tree["ids"]))), "roundtrip is bitwise")
        flat, _ = load_checkpoint_arrays(d1)
        check(not flat["emb"].flags.writeable,
              "loaded arrays are zero-copy read-only views")
        check(manifest["meta"]["step"] == 3, "meta rides the manifest")

        # -- 2. corruption is typed and NAMED ----------------------------
        payload = os.path.join(d1, manifest["payload"])
        ent = next(t for t in manifest["tensors"] if t["name"] == "ids")
        with open(payload, "r+b") as f:
            f.seek(ent["offset"])
            b = f.read(1)
            f.seek(ent["offset"])
            f.write(bytes([b[0] ^ 0xFF]))
        try:
            load_checkpoint_arrays(d1)
            check(False, "bit flip detected")
        except CheckpointCorruptError as e:
            check(e.tensor == "ids" and "ids" in str(e),
                  "bit flip fails naming tensor 'ids'")
        with open(payload, "r+b") as f:  # heal for the next case
            f.seek(ent["offset"])
            f.write(b)
        with open(payload, "r+b") as f:
            f.truncate(ent["offset"] + 2)
        try:
            load_checkpoint_arrays(d1)
            check(False, "truncation detected")
        except CheckpointCorruptError as e:
            check(e.tensor == "ids", "truncation fails naming tensor")

        # -- 3. torn-write discipline: crash keeps the previous ----------
        d2 = os.path.join(tmp, "ck2")
        save_checkpoint_tree(d2, {"w": np.full(4, 1.0, np.float32)})
        with faults.scoped("crash@checkpoint.save:0"):
            try:
                save_checkpoint_tree(
                    d2, {"w": np.full(4, 2.0, np.float32)})
                check(False, "fault site fired")
            except faults.InjectedFault:
                check(True, "crash injected at checkpoint.save")
        got2, _ = load_checkpoint_tree(d2)
        check(float(got2["w"][0]) == 1.0,
              "crashed save left the previous checkpoint intact")
        save_checkpoint_tree(d2, {"w": np.full(4, 2.0, np.float32)})
        got2, m2 = load_checkpoint_tree(d2)
        orphans = [n for n in os.listdir(d2)
                   if n.startswith("segments-") and n != m2["payload"]]
        check(float(got2["w"][0]) == 2.0 and not orphans,
              "retry committed and swept the orphaned payload")

        # -- 4. decoder contract: save/load + validation -----------------
        from ..serving.decode import (DecoderSpec, build_decoder_params,
                                      decoder_step)

        spec = DecoderSpec(vocab=16, d_model=8, n_layers=1, n_heads=2,
                           n_kv_heads=1, seed=5)
        d3 = os.path.join(tmp, "dec")
        save_decoder_checkpoint(d3, spec, step=7)
        spec2, params2 = load_decoder_checkpoint(d3, device="cpu")
        check(spec2.to_dict() == spec.to_dict(),
              "DecoderSpec roundtrips through the manifest meta")
        params = build_decoder_params(spec, device="cpu")

        def step(p, s):
            pool = torch.zeros((1, 3, 4, 1, 4))
            with torch.no_grad():
                return decoder_step(
                    p, s, torch.tensor([3], dtype=torch.int32),
                    torch.tensor([0], dtype=torch.int32), pool,
                    pool.clone(), torch.tensor([[1, 0, 0]],
                                               dtype=torch.int32),
                    torch.tensor([1], dtype=torch.int32))[2]

        check(torch.equal(step(params, spec), step(params2, spec2)),
              "loaded decoder's logits are bitwise the saved one's")

        # re-save d1 first: case 2 left its payload truncated, and a
        # corrupt checkpoint would fail verification BEFORE the kind
        # check this case exists to prove
        save_checkpoint_tree(d1, tree, meta={"step": 3})
        try:
            load_decoder_checkpoint(d1, device="cpu")
            check(False, "non-decoder checkpoint refused")
        except CheckpointCorruptError:
            check(False, "non-decoder refusal reached the kind check")
        except CheckpointError:
            check(True, "non-decoder checkpoint refused (typed)")
        # a tensor the spec doesn't expect fails NAMED, pre-device
        save_checkpoint_tree(
            d3, {**params, "rogue": np.zeros(2)},
            meta=read_manifest(d3)["meta"])
        try:
            load_decoder_checkpoint(d3, device="cpu")
            check(False, "contract drift refused")
        except CheckpointError as e:
            check("rogue" in str(e),
                  "contract drift names the unexpected tensor")

    if failures:
        print(f"checkpoint selftest: {len(failures)} FAILURE(S): "
              f"{failures}")
        return 1
    print("checkpoint selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.checkpoint")
    ap.add_argument("--selftest", action="store_true",
                    help="run the in-process selftest")
    sub = ap.add_subparsers(dest="cmd")
    p_ins = sub.add_parser("inspect", help="print a manifest summary")
    p_ins.add_argument("dir")
    p_ver = sub.add_parser("verify", help="full checksum pass")
    p_ver.add_argument("dir")
    args = ap.parse_args(argv)

    if args.selftest:
        return run_selftest()
    if args.cmd == "inspect":
        return cmd_inspect(args.dir)
    if args.cmd == "verify":
        return cmd_verify(args.dir)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
