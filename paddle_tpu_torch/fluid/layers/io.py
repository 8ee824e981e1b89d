"""Input layers (reference python/paddle/fluid/layers/io.py — data:28,
open_recordio_file:281, open_files:353, shuffle:467, batch, double_buffer:472,
read_file:490), copied from ``paddle_tpu/fluid/layers/io.py``: the same
ops, attrs and reader vars, so a reader program's ``to_bytes()`` equals
the JAX package's.

Reader-as-variable: the creation ops live in the STARTUP program (running
it (re)builds the host reader decorator stack into scope — re-running
startup IS the reset, like the reference's ReInit); the MAIN program
carries only the `read` op, which the Executor resolves as a host
pre-pass into the step's feeds (readers.py). `double_buffer` is the async
rung: its threads overlap batch decode and the host-to-card copy with
the card's compute. ``Send``, ``Recv`` and ``ListenAndServ`` are the
parameter-server transport's layers, with the JAX package's op types
and attrs.
"""
from __future__ import annotations

import contextlib

from .. import core, unique_name
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = [
    "data", "open_recordio_file", "open_files", "shuffle", "batch",
    "double_buffer", "multi_pass", "read_file", "reset_reader",
    "Send", "Recv", "ListenAndServ",
]


def data(
    name,
    shape,
    append_batch_size: bool = True,
    dtype="float32",
    lod_level: int = 0,
    type=None,
    stop_gradient: bool = True,
):
    """Feed placeholder (reference layers/io.py:28)."""
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if block.has_var(name):
        return block.var(name)
    var = block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=stop_gradient,
        persistable=False,
    )
    if lod_level > 0:
        # padded+lengths sequence representation (see layers/sequence.py):
        # a ragged feed becomes [N, T, ...] plus an int32 lengths companion
        if len(shape) < 2 or shape[1] != -1:
            var.desc.shape = [shape[0], -1] + shape[1:]
        block.create_var(
            name=name + "@LEN", shape=[-1], dtype="int32",
            stop_gradient=True, persistable=False,
        )
    return var


def _normalize_slots(shapes, dtypes, lod_levels):
    if lod_levels is None:
        lod_levels = [0] * len(shapes)
    if not (len(shapes) == len(dtypes) == len(lod_levels)):
        raise ValueError(
            f"shapes ({len(shapes)}), dtypes ({len(dtypes)}) and lod_levels "
            f"({len(lod_levels)}) must align"
        )
    return [
        {"shape": list(s), "dtype": core.convert_dtype(d), "lod_level": int(l)}
        for s, d, l in zip(shapes, dtypes, lod_levels)
    ]


def _create_reader(op_type, attrs, slots, underlying=None):
    """Append a reader-creation op + READER var to the STARTUP program and
    mirror the var into the main program (reference _copy_reader_var_)."""
    startup = default_startup_program()
    main = default_main_program()
    name = unique_name.generate(op_type.replace("create_", "") + ".reader")
    sblock = startup.global_block()
    svar = sblock.create_var(
        name=name, type=core.VarType.READER, persistable=True,
        stop_gradient=True, shape=None,
    )
    svar.desc.reader_slots = slots
    inputs = {}
    if underlying is not None:
        inputs["UnderlyingReader"] = [underlying.name]
    sblock.append_op(op_type, inputs=inputs, outputs={"Out": [name]},
                     attrs=attrs)
    mvar = main.global_block().create_var(
        name=name, type=core.VarType.READER, persistable=True,
        stop_gradient=True, shape=None,
    )
    mvar.desc.reader_slots = slots
    return mvar


def open_recordio_file(filename, shapes, lod_levels=None, dtypes=None):
    """Reader over one recordio file of pickled slot tuples (reference
    layers/io.py:281; file written by
    recordio_writer.convert_reader_to_recordio_file)."""
    dtypes = dtypes or ["float32"] * len(shapes)
    slots = _normalize_slots(shapes, dtypes, lod_levels)
    return _create_reader(
        "create_recordio_file_reader", {"filename": str(filename)}, slots
    )


def open_files(filenames, shapes, lod_levels=None, dtypes=None,
               thread_num: int = 2, buffer_size: int = 256):
    """Multi-shard reader with threaded chunk prefetch (reference
    open_files_op.cc / layers/io.py:353)."""
    dtypes = dtypes or ["float32"] * len(shapes)
    slots = _normalize_slots(shapes, dtypes, lod_levels)
    return _create_reader(
        "open_files",
        {"filenames": [str(f) for f in filenames],
         "thread_num": int(thread_num), "buffer_size": int(buffer_size)},
        slots,
    )


def _decorated(op_type, reader, attrs, slots=None):
    if reader.desc.reader_slots is None:
        raise ValueError(f"'{reader.name}' is not a reader variable")
    return _create_reader(op_type, attrs, slots or reader.desc.reader_slots,
                          underlying=reader)


def shuffle(reader, buffer_size: int, seed: int = 0):
    """reference layers/io.py:467."""
    return _decorated("create_shuffle_reader", reader,
                      {"buffer_size": int(buffer_size), "seed": int(seed)})


def batch(reader, batch_size: int, drop_last: bool = False):
    """Stack samples into minibatches. drop_last=True keeps every batch the
    same shape (in the JAX package, one XLA executable)."""
    slots = [
        {"shape": [-1] + list(s["shape"]), "dtype": s["dtype"],
         "lod_level": s["lod_level"]}
        for s in (reader.desc.reader_slots or [])
    ]
    return _decorated("create_batch_reader", reader,
                      {"batch_size": int(batch_size),
                       "drop_last": bool(drop_last)}, slots or None)


def multi_pass(reader, pass_num: int):
    """Replay the data `pass_num` epochs before EOF (reference
    create_multi_pass_reader_op.cc)."""
    return _decorated("create_multi_pass_reader", reader,
                      {"pass_num": int(pass_num)})


def double_buffer(reader, place=None, capacity: int = 2):
    """Async prefetch decorator (reference layers/io.py:472,
    create_double_buffer_reader_op.cc): a daemon thread decodes batch N+1
    and another copies it to the card while the card runs batch N.
    `place` kept for API parity; the transfer targets the device of the
    executor that runs the startup program."""
    del place
    return _decorated("create_double_buffer_reader", reader,
                      {"capacity": int(capacity)})


def read_file(reader):
    """Pop one minibatch from a reader variable (reference layers/io.py:490,
    read_op.cc). Returns one Variable per declared slot; raises
    core.EOFException from Executor.run at end of data."""
    slots = reader.desc.reader_slots
    if not slots:
        raise ValueError(f"'{reader.name}' is not a reader variable")
    helper = LayerHelper("read_file")
    block = helper.main_program.current_block()
    outs = []
    for i, s in enumerate(slots):
        name = unique_name.generate(f"{reader.name}.slot{i}")
        var = block.create_var(
            name=name, shape=list(s["shape"]), dtype=s["dtype"],
            lod_level=s["lod_level"], stop_gradient=True, persistable=False,
        )
        if s["lod_level"] > 0:
            block.create_var(
                name=name + "@LEN", shape=[-1], dtype="int32",
                stop_gradient=True, persistable=False,
            )
        outs.append(var)
    block.append_op(
        "read", inputs={"Reader": [reader.name]},
        outputs={"Out": [v.name for v in outs]},
    )
    return outs


def reset_reader(reader, scope=None):
    """Rewind a reader's host object (reference ReaderHolder::ReInit via
    reader.reset()). Equivalent to re-running the startup program, but
    without re-initializing parameters."""
    from ..executor import global_scope

    scope = scope or global_scope()
    obj = scope.find_var(reader.name if hasattr(reader, "name") else reader)
    if obj is None or not hasattr(obj, "reset"):
        raise ValueError("no host reader in scope for "
                         f"'{getattr(reader, 'name', reader)}' — run the "
                         "startup program first")
    obj.reset()

def _epmap(endpoints):
    if isinstance(endpoints, (list, tuple)):
        eps = [str(e) for e in endpoints if e]
    else:
        eps = [e for e in str(endpoints).split(",") if e]
    if not eps:
        raise ValueError("Send/Recv need at least one endpoint")
    return eps


def Send(endpoints, send_vars, get_vars=None, trainer_id=0):
    """Send layer (reference layers/io.py:173 -> send_op.cc): push
    `send_vars` to the pserver(s), optionally pulling `get_vars` back
    (AFTER the push — the executor barriers a sync round first). Each var
    maps round-robin onto the endpoints (list or comma string); a var
    named `<param>@GRAD` pushes to the server's `<param>` slot, and a
    get_var pulls from the endpoint its gradient was pushed to. Multiple
    sync trainers must pass their own trainer_id."""
    epmap = _epmap(endpoints)
    helper = LayerHelper("Send")
    block = helper.main_program.current_block()
    names = [v.name if hasattr(v, "name") else str(v) for v in send_vars]
    get_names = [v.name if hasattr(v, "name") else str(v)
                 for v in (get_vars or [])]
    send_eps = {n: epmap[i % len(epmap)] for i, n in enumerate(names)}
    params = {n: n.split("@GRAD")[0] for n in names}
    # a pulled param lives wherever its gradient went; names not among the
    # pushed params fall back to round robin
    param_home = {params[n]: send_eps[n] for n in names}
    block.append_op(
        "send", inputs={"X": names}, outputs={"Out": get_names},
        attrs={
            "endpoints": send_eps,
            "params": params,
            "recv_endpoints": {
                n: param_home.get(n, epmap[i % len(epmap)])
                for i, n in enumerate(get_names)},
            "trainer_id": int(trainer_id),
        },
    )


def Recv(endpoints, get_vars):
    """Recv layer (reference layers/io.py:205 -> recv_op.cc): pull current
    values of `get_vars` from their pservers into scope before the step."""
    epmap = _epmap(endpoints)
    helper = LayerHelper("Recv")
    block = helper.main_program.current_block()
    names = [v.name if hasattr(v, "name") else str(v) for v in get_vars]
    block.append_op(
        "recv", inputs={}, outputs={"Out": names},
        attrs={"endpoints": {n: epmap[i % len(epmap)]
                             for i, n in enumerate(names)}},
    )


class ListenAndServ:
    """Server-side wrapper (reference layers/io.py:107 ListenAndServ over
    listen_and_serv_op): capture a block of optimize ops with `do()`, then
    `run(scope)` serves them behind the ParameterServer RPC service — the
    op that never returns becomes a service object.

        serv = ListenAndServ("127.0.0.1:6174", inputs=[w], fan_in=1)
        with serv.do():
            layers.sgd-style optimize ops over (param, grad)
        ps = serv.run(scope)   # serves until ps.shutdown()
    """

    def __init__(self, endpoint, inputs=None, fan_in=1,
                 optimizer_mode=True):
        self.helper = LayerHelper("listen_and_serv")
        self.endpoint = str(endpoint)
        self.inputs = list(inputs or [])
        self.fan_in = int(fan_in)
        self.optimizer_mode = optimizer_mode
        self._sub = None

    @contextlib.contextmanager
    def do(self):
        main = self.helper.main_program
        self._sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()

    def get_params_and_grads(self):
        """(param names, grad names) captured in the block (reference
        get_params_and_grads)."""
        params, grads = [], []
        for op in self._sub.ops:
            ins = op.desc.inputs
            if self.optimizer_mode:
                if "Param" in ins and "Grad" in ins:
                    params.append(ins["Param"][0])
                    grads.append(ins["Grad"][0])
            else:
                for names in ins.values():
                    params.extend(names)
                    grads.extend(names)
        return params, grads

    def _build_server_program(self):
        from ..framework import Program

        prog = Program()
        block = prog.global_block()
        params, _ = self.get_params_and_grads()
        parent = self.helper.main_program.global_block()
        needed = set(params)
        for op in self._sub.ops:
            needed.update(n for n in op.desc.input_names() if n)
            needed.update(n for n in op.desc.output_names() if n)
        for n in needed:
            src = self._sub._var_recursive(n) or parent._var_recursive(n)
            v = block.create_var(
                name=n,
                shape=list(src.shape) if src is not None and src.shape
                else None,
                dtype=src.dtype if src is not None else "float32",
                persistable=True,
            )
            if n in params:
                v.desc.is_parameter = True
        import copy as _copy

        from ..framework import Operator

        for op in self._sub.ops:
            new = Operator.__new__(Operator)
            new.block = block
            new.desc = _copy.deepcopy(op.desc)
            block.ops.append(new)
        prog._bump_version()
        return prog

    def run(self, scope=None, port=None, device=None):
        """Serve the captured block (returns the live ParameterServer —
        call .shutdown() to stop). Params initialize from `scope` (default:
        the current global scope, i.e. the builder's own state); the
        optimize ops run on `device` (None: the card, raising without
        one)."""
        from ...distributed.param_server import ParameterServer
        from ..executor import global_scope

        prog = self._build_server_program()
        ps = ParameterServer(prog, trainers=self.fan_in,
                             sync_mode=self.fan_in > 1,
                             scope=scope or global_scope(), device=device)
        if port is None:
            port = int(self.endpoint.rsplit(":", 1)[1])
        ps.serve(port=port)
        return ps
