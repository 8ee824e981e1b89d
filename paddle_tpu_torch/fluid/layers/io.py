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
the card's compute. ``Send``, ``Recv`` and ``ListenAndServ`` (the
parameter-server transport) are not ported yet.
"""
from __future__ import annotations

from .. import core, unique_name
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = [
    "data", "open_recordio_file", "open_files", "shuffle", "batch",
    "double_buffer", "multi_pass", "read_file", "reset_reader",
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
