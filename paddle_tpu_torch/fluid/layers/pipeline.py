"""Pipeline-parallel region builder: partitions a span of the Program into
GPipe stages run over the mesh's ``pp`` axis — the counterpart of
``paddle_tpu/fluid/layers/pipeline.py``.

Built the way While/DynamicRNN are: the staged ops live in a sub-block,
the region is ONE ``pipeline`` op in the parent block, and the emitter
(``ops/pipeline_op.py``) runs the stages in sequence, or as a GPipe
schedule over ``pp`` under a ParallelExecutor mesh. ``append_backward``
differentiates the whole region through the generic gradient.

    pipe = layers.Pipeline(x, n_microbatches=4)   # x: [B, ...] activation
    with pipe.block():
        h = layers.fc(input=pipe.input, size=64, act='relu')   # stage 0
        h = pipe.cut(h)                                        # stage cut
        h = layers.fc(input=h, size=64, act='relu')            # stage 1
    out = pipe.output(h)                                       # [B, ...]

Contract (checked by the emitter): the region input, every cut
activation, and the region output share one shape/dtype. The number of
stages (cuts + 1) must equal the mesh's ``pp`` axis size; without a
``pp`` mesh axis the region runs sequentially with identical semantics.
"""
from __future__ import annotations

import contextlib

from ..layer_helper import LayerHelper

__all__ = ["Pipeline"]


class Pipeline:
    def __init__(self, input, n_microbatches=None, name=None):
        self.helper = LayerHelper("pipeline", name=name)
        self._x = input
        self._n_micro = int(n_microbatches) if n_microbatches else 0
        self._sub = None
        self._parent = None
        self._in_var = None
        self._n_cuts = 0
        self._out = None

    @property
    def input(self):
        """The region input as the stage-0 ops inside ``block()`` read
        it."""
        if self._in_var is None:
            raise RuntimeError("Pipeline.input is only valid inside block()")
        return self._in_var

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        self._parent = main.current_block()
        self._sub = main.create_block()
        self._in_var = self._sub.create_var(
            name=self._x.name + "@pipe_in", dtype=self._x.dtype,
            shape=list(self._x.shape) if self._x.shape else None,
        )
        try:
            yield
        finally:
            main.rollback()

    def cut(self, var):
        """Marks ``var`` as the activation handed to the next stage."""
        if self._sub is None:
            raise RuntimeError("Pipeline.cut() must be called inside block()")
        self._sub.append_op(
            type="pipeline_cut", inputs={"X": [var]}, outputs={},
            attrs={"index": self._n_cuts},
        )
        self._n_cuts += 1
        return var

    def output(self, var):
        """Completes the region; returns the parent-block output var."""
        if self._sub is None:
            raise RuntimeError("Pipeline.output() after block()")
        sub, parent = self._sub, self._parent
        # outer vars the staged ops read (params + any captured tensors);
        # the region input arrives separately as X
        from .control_flow import _outer_reads

        params = _outer_reads(sub, parent, exclude={self._in_var.name})
        out_var = parent.create_var(
            name=self.helper.name + ".out", dtype=var.dtype,
            shape=list(self._x.shape) if self._x.shape else None,
        )
        parent.append_op(
            type="pipeline",
            inputs={"X": [self._x], "Params": params},
            outputs={"Out": [out_var]},
            attrs={
                "sub_block": sub.idx,
                "in_var_name": self._in_var.name,
                "out_var_name": var.name,
                "n_stages": self._n_cuts + 1,
                "n_microbatches": self._n_micro,
                "param_var_names": params,
            },
        )
        self._out = out_var
        return out_var
