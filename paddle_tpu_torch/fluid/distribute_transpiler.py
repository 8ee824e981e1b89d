"""DistributeTranspiler — the API facade of the reference's program
rewrite over the port's mesh layer: the counterpart of
``paddle_tpu/fluid/distribute_transpiler.py``.

The reference rewrites one program into trainer+pserver halves
(python/paddle/fluid/distribute_transpiler.py:136 transpile,
:263 get_pserver_program — split grads, append send/recv ops, build
per-param optimize sub-blocks behind listen_and_serv). The JAX package
runs the SAME program SPMD over a mesh of all trainers' devices, and so
does the port: gradient aggregation is the all-reduce DTensor inserts
where the batch axis is sharded (ParallelExecutor). This facade keeps the
reference entry points:

  - `transpile(...)` computes the param->pserver assignment (round_robin /
    hash_name, reference distributed_splitter.py) and the mesh/plan
    equivalent;
  - `get_trainer_program()` is the identity (SPMD needs no rewrite);
  - `get_pserver_program(ep)` returns the sliced program a pserver at `ep`
    would own — params assigned to it plus the optimize ops that update
    them — preserving the reference's program-rewrite-assertion test
    pattern and serving as the placement inspector;
  - `mesh()` / `sharding_plan()` hand ParallelExecutor the real thing.

Sparse embedding sharding (the pserver path's one unique capability,
doc/fluid/design/dist_train/distributed_lookup_table_design.md) maps to
plan rules sharding the embedding table rows over the mesh.

The reference flow itself runs too: `get_trainer_program(send_recv=True)`
builds the program with `send`/`recv`/`prefetch` ops, which the port's
Executor runs as host ops around the step, against the parameter servers
that `start_pserver` serves (distributed/param_server.py).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

from .framework import Parameter, Program, default_main_program

__all__ = ["DistributeTranspiler", "round_robin", "hash_name"]


def round_robin(varlist: Sequence, pserver_endpoints: Sequence[str]):
    """reference distributed_splitter.py round_robin."""
    assignment = {}
    for i, var in enumerate(varlist):
        name = getattr(var, "name", var)
        assignment[name] = pserver_endpoints[i % len(pserver_endpoints)]
    return assignment


def hash_name(varlist: Sequence, pserver_endpoints: Sequence[str]):
    """reference distributed_splitter.py hash_name (stable hash here —
    python's builtin hash is salted per process)."""
    assignment = {}
    for var in varlist:
        name = getattr(var, "name", var)
        h = int(hashlib.md5(name.encode()).hexdigest(), 16)
        assignment[name] = pserver_endpoints[h % len(pserver_endpoints)]
    return assignment


class DistributeTranspiler:
    def __init__(self):
        self._program: Optional[Program] = None
        self._startup: Optional[Program] = None
        self.trainer_id = 0
        self.trainers = 1
        self.pserver_endpoints: List[str] = []
        self.param_assignment: Dict[str, str] = {}
        self._embedding_rules: List[str] = []

    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  startup_program: Optional[Program] = None,
                  pservers: str = "", trainers: int = 1,
                  split_method=round_robin, sync_mode: bool = True):
        self._program = program or default_main_program()
        self._startup = startup_program
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync_mode = sync_mode
        self.pserver_endpoints = [p for p in pservers.split(",") if p]
        params = [v for v in self._program.list_vars()
                  if isinstance(v, Parameter)]
        if self.pserver_endpoints:
            self.param_assignment = split_method(params,
                                                 self.pserver_endpoints)
        # embeddings marked distributed shard their rows over the mesh —
        # the sparse-pserver capability, on the mesh
        for op in self._program.global_block().ops:
            if op.desc.type == "lookup_table" and (
                    op.desc.attrs.get("is_distributed")
                    or op.desc.attrs.get("is_sparse")):
                w = (op.desc.inputs.get("W") or [""])[0]
                if w:
                    self._embedding_rules.append(w)
        return self

    # -- mesh execution handles ------------------------------------------
    def mesh(self, devices=None, axis_name: str = "dp"):
        """Data-parallel ``DeviceMesh`` over all trainers' devices: one
        axis of the process group's world size (a world of one starts its
        own group). ``devices``: the device type (``"cuda"``, the default,
        or ``"cpu"``)."""
        import torch.distributed as dist

        from ..parallel import make_mesh

        n = dist.get_world_size() if dist.is_initialized() else 1
        return make_mesh({axis_name: n}, devices=devices)

    def sharding_plan(self, batch_axis: str = "dp",
                      embedding_axis: Optional[str] = None):
        from ..parallel import P, ShardingPlan

        plan = ShardingPlan(batch_axis=batch_axis)
        axis = embedding_axis or batch_axis
        for w in self._embedding_rules:
            import re as _re

            plan.add(rf"^{_re.escape(w)}(_\w+)?$", P(axis))
        return plan

    # -- reference-API program views -------------------------------------
    def get_trainer_program(self, send_recv: bool = False) -> Program:
        """Default (SPMD): the trainer program IS the program — gradient
        aggregation is the all-reduce DTensor inserts.

        send_recv=True builds the REFERENCE flow (transpile:136): optimize
        ops move to the pserver; the trainer program gets a `recv` op up
        front (pull current params) and a `send` op at the end (push
        gradients) — host RPC ops the Executor runs around the step
        (send_op.cc / recv_op.cc). With sync_mode a send_barrier op
        follows the send (send_barrier_op.cc)."""
        if not send_recv:
            return self._program
        if not self.param_assignment:
            raise ValueError("transpile() was not given pserver endpoints")
        prog = self._program.clone()
        block = prog.global_block()
        owned = set(self.param_assignment)
        # strip the param-updating (optimize) ops — they now run on the
        # pserver; the LR-schedule chain left behind is dead scalar code
        pairs = []  # (param, grad) in op order
        kept = []
        for op in block.ops:
            outs = set(op.desc.output_names())
            if outs & owned:
                p = next(iter(outs & owned))
                g = (op.desc.inputs.get("Grad") or [p + "@GRAD"])[0]
                pairs.append((p, g))
                continue
            kept.append(op)
        block.ops = kept
        if not pairs:
            raise ValueError("no optimize ops found to transpile — call "
                             "minimize() before transpile()")

        from .framework import Operator

        # --- row-granular sparse prefetch (reference prefetch_op.cc +
        # doc/fluid/design/dist_train/ distributed-lookup-table design) ---
        # A lookup_table marked is_distributed whose table lives on a
        # pserver is rewritten so the trainer never ships the table:
        #   * a host `prefetch` op pulls ONLY the batch's unique rows into
        #     a [n_ids, dim] sub-table fed to the device step, and feeds
        #     locally-remapped ids;
        #   * forward + grad lookups index the sub-table (static shapes —
        #     the sub-table is padded to the flat id count);
        #   * the grad becomes SelectedRows over LOCAL rows; the send op
        #     maps them back to global rows (scope-stashed id map) before
        #     the push.
        sparse_remap: Dict[str, Dict] = {}
        dist_tables: Dict[str, List] = {}
        for op in block.ops:
            if op.desc.type == "lookup_table" and \
                    op.desc.attrs.get("is_distributed"):
                w = (op.desc.inputs.get("W") or [""])[0]
                if w in owned:
                    dist_tables.setdefault(w, []).append(op)
        prefetch_ops = []
        for w, lookups in dist_tables.items():
            if len(lookups) > 1:
                # two lookups of one table would need per-op sub-tables with
                # a merged grad push; fall back to the dense path honestly
                import warnings

                warnings.warn(
                    f"distributed table '{w}' has {len(lookups)} lookups — "
                    "row-granular prefetch supports one; using dense "
                    "send/recv for it")
                continue
            op = lookups[0]
            from .registry import FWD_META_ATTR

            ids_name = (op.desc.inputs.get("Ids") or [""])[0]
            wvar = block.vars[w]
            dim = list(wvar.shape)[1]
            vocab = list(wvar.shape)[0]
            sub = block.create_var(
                name=f"{w}@SUB", dtype=wvar.dtype, shape=[-1, dim],
                persistable=False, stop_gradient=True)
            remap = block.create_var(
                name=f"{ids_name}@REMAP", dtype="int64",
                shape=list(block.vars[ids_name].shape or [-1]),
                persistable=False, stop_gradient=True)
            padding_idx = int(op.desc.attrs.get("padding_idx", -1))
            # forward: index the prefetched sub-table with local ids; the
            # prefetch op zeroes the padding row host-side, so the op-level
            # padding handling is disabled
            op.desc.inputs["W"] = [sub.name]
            op.desc.inputs["Ids"] = [remap.name]
            op.desc.attrs["padding_idx"] = -1
            for gop in block.ops:
                if gop.desc.type != "lookup_table_grad":
                    continue
                if (gop.desc.inputs.get("W") or [""])[0] != w:
                    continue
                gop.desc.inputs["W"] = [sub.name]
                gop.desc.inputs["Ids"] = [remap.name]
                meta = gop.desc.attrs.get(FWD_META_ATTR)
                if meta:
                    meta["attrs"]["is_sparse"] = True
                    meta["attrs"]["padding_idx"] = -1
            prefetch_ops.append(Operator(
                block, "prefetch", inputs={"Ids": [ids_name]},
                outputs={"Out": [sub.name], "Remap": [remap.name]},
                attrs={"endpoint": self.param_assignment[w], "param": w,
                       "vocab": vocab, "padding_idx": padding_idx},
            ))
            gname = next(g for p, g in pairs if p == w)
            sparse_remap[gname] = {"param": w, "vocab": vocab,
                                   "padding_idx": padding_idx}

        prefetched = {info["param"] for info in sparse_remap.values()}
        recv_params = [p for p, _ in pairs if p not in prefetched]
        if recv_params:
            recv = Operator(
                block, "recv", inputs={},
                outputs={"Out": recv_params},
                attrs={"endpoints": {p: self.param_assignment[p]
                                     for p in recv_params}},
            )
            block.ops.insert(0, recv)
        for pf in prefetch_ops:
            block.ops.insert(0, pf)
        send = Operator(
            block, "send", inputs={"X": [g for _, g in pairs]},
            outputs={},
            attrs={
                "endpoints": {g: self.param_assignment[p] for p, g in pairs},
                "params": {g: p for p, g in pairs},
                "trainer_id": self.trainer_id,
                "sparse_remap": sparse_remap,
            },
        )
        block.ops.append(send)
        if getattr(self, "sync_mode", True) and self.trainers > 1:
            barrier = Operator(
                block, "send_barrier", inputs={}, outputs={},
                attrs={"endpoints": sorted(set(self.param_assignment.values())),
                       # the barrier names its CALLER so a heartbeat-enabled
                       # pserver refreshes this trainer's lease while it is
                       # parked waiting (a waiting trainer is alive — without
                       # this it could be evicted mid-wait and lose its round)
                       "trainer_id": self.trainer_id},
            )
            block.ops.append(barrier)
        prog._bump_version()
        return prog

    def get_trainer_startup_program(self) -> Program:
        """Trainer-side startup with distributed-table initializers removed:
        a prefetched table lives ONLY on its pserver (the design's point is
        a vocab too large for trainer memory — reference
        distributed_lookup_table_design.md), so the trainer must not
        materialize [vocab, dim] locally."""
        if self._startup is None:
            raise ValueError("transpile() was not given a startup_program")
        dist = set()
        for op in self._program.global_block().ops:
            if op.desc.type == "lookup_table" and \
                    op.desc.attrs.get("is_distributed"):
                w = (op.desc.inputs.get("W") or [""])[0]
                if w in self.param_assignment:
                    dist.add(w)
        # a distributed table's optimizer accumulators are vocab-sized too,
        # and their optimize ops were stripped to the pserver — initializing
        # them on the trainer would materialize the very arrays this pruning
        # exists to avoid. The prune set is EXACT: the table plus the output
        # vars of its optimize ops (ParamOut/MomentOut/... name the in-place
        # accumulator vars) — a wildcard <w>_* suffix would also swallow
        # unrelated params that merely share the prefix (e.g. 'emb_proj'
        # next to table 'emb')
        prune = set(dist)
        for op in self._program.global_block().ops:
            outs = set(op.desc.output_names())
            if dist & outs:
                prune.update(outs)

        def _is_dist(n):
            return n in prune

        pruned = self._startup.clone()
        block = pruned.global_block()
        block.ops = [op for op in block.ops
                     if not any(_is_dist(n) for n in op.desc.output_names())]
        block.vars = {n: v for n, v in block.vars.items() if not _is_dist(n)}
        pruned._bump_version()
        return pruned

    def start_pserver(self, endpoint: str, host: str = "127.0.0.1",
                      port: int = 0, sync_mode: Optional[bool] = None,
                      device=None, **server_kwargs):
        """Build this endpoint's pserver program pair and serve it
        (reference listen_and_serv_op.cc:78 behind trainer RPC). Returns
        the running ParameterServer; its .address is what trainers dial.
        `device`: where the pserver's optimizer runs and its state lives
        (None: the card, raising without one). Extra kwargs
        (heartbeat_timeout, barrier_timeout, ...) pass through to the
        ParameterServer constructor."""
        from ..distributed.param_server import ParameterServer

        pp = self.get_pserver_program(endpoint)
        ps = ParameterServer(
            pp,
            self.get_startup_program(endpoint, pp),
            trainers=self.trainers,
            sync_mode=self.sync_mode if sync_mode is None else sync_mode,
            device=device,
            **server_kwargs,
        )
        ps.serve(host, port)
        return ps

    def _owned_params(self, endpoint: str) -> List[str]:
        return [n for n, ep in self.param_assignment.items() if ep == endpoint]

    def get_pserver_program(self, endpoint: str) -> Program:
        """The slice of work a pserver at `endpoint` would own: its params'
        optimize ops PLUS their transitive dependency chain on the optimize
        side — learning-rate decay schedules, step counters, accumulator
        setup (the reference builds exactly these as per-param sub-blocks
        behind listen_and_serv, :263, and moves the LR-decay ops to the
        pserver). Gradients are the boundary: ops consuming @GRAD values
        stay trainer-side (in the reference the trainer sends them; here
        the all-reduce DTensor inserts plays that role), so the closure
        stops at gradient inputs."""
        from .framework import grad_var_name  # noqa: F401  (doc anchor)

        owned = set(self._owned_params(endpoint))
        pruned = self._program.clone()
        block = pruned.global_block()

        def is_grad_name(n):
            return "@GRAD" in n

        # seed: ops updating an owned param in place
        keep = set()
        needed = set()
        for i, op in enumerate(block.ops):
            outs = set(op.desc.output_names())
            if outs & owned:
                keep.add(i)
                needed.update(
                    n for n in op.desc.input_names()
                    if n and not is_grad_name(n) and n not in owned
                )
        # backward closure over producers of needed values: pulls in the
        # LR-schedule chain (counters, decay arithmetic) but not the
        # forward/backward graph — any op touching a gradient stays on the
        # trainer side of the send boundary
        for i in range(len(block.ops) - 1, -1, -1):
            if i in keep:
                continue
            op = block.ops[i]
            outs = set(n for n in op.desc.output_names() if n)
            if not (outs & needed):
                continue
            ins = [n for n in op.desc.input_names() if n]
            if any(is_grad_name(n) for n in ins + list(outs)):
                continue
            keep.add(i)
            needed.update(n for n in ins if n not in owned)

        keep_ops = [op for i, op in enumerate(block.ops) if i in keep]
        used = set(owned)
        for op in keep_ops:
            used.update(n for n in op.desc.input_names() if n)
            used.update(n for n in op.desc.output_names() if n)
        block.ops = keep_ops
        block.vars = {n: v for n, v in block.vars.items() if n in used}
        return pruned

    def get_startup_program(self, endpoint: str,
                            pserver_program: Optional[Program] = None
                            ) -> Program:
        """Initializers this pserver needs: its params, their optimizer
        accumulators, LR/step globals — i.e. every var the pserver program
        reads or writes (the reference builds exactly this, :400)."""
        if self._startup is None:
            raise ValueError("transpile() was not given a startup_program")
        if pserver_program is None:
            pserver_program = self.get_pserver_program(endpoint)
        wanted = set(pserver_program.global_block().vars)
        pruned = self._startup.clone()
        block = pruned.global_block()
        keep_ops = [op for op in block.ops
                    if set(op.desc.output_names()) & wanted]
        used = set(wanted)
        for op in keep_ops:
            used.update(n for n in op.desc.input_names() if n)
        block.ops = keep_ops
        block.vars = {n: v for n, v in block.vars.items() if n in used}
        return pruned
