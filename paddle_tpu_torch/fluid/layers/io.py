"""Input layers (reference python/paddle/fluid/layers/io.py — data:28):
``data``, copied from ``paddle_tpu/fluid/layers/io.py``. Readers, the
recordio/file stack and send/recv are not ported yet."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data"]


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
