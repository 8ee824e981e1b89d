"""DataFeeder (reference python/paddle/fluid/data_feeder.py:69) — converts
per-sample python/numpy data into batched feed arrays: a copy of
``paddle_tpu/fluid/data_feeder.py``, whose feed dicts (numpy) it gives bit
for bit. The executor moves them to its device."""
from __future__ import annotations

import numpy as np

from .core import convert_dtype
from .framework import Variable


class DataToLoDTensorConverter:
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = [d for d in shape]
        self.dtype = dtype
        self.data = []

    def feed(self, data):
        # lod_level>0: keep the ragged sample whole; done() pads + lengths
        self.data.append(data)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            shape = [d if d >= 0 else -1 for d in self.shape]
            # conform samples to the declared var shape (reference feeds flat
            # reader rows into e.g. [1,28,28] data vars)
            if shape[1:] and tuple(arr.shape[1:]) != tuple(shape[1:]):
                arr = arr.reshape([arr.shape[0]] + [d for d in shape[1:]])
            return arr
        if self.lod_level > 1:
            raise NotImplementedError(
                "nested (lod_level>1) sequences: flatten or bucket upstream"
            )
        # ragged -> padded [N, T, ...] + lengths, T bucketed to a power of
        # two as in the JAX package (where it bounds XLA recompilations)
        seqs = [np.asarray(s, dtype=self.dtype) for s in self.data]
        lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
        max_len = max(1, int(lengths.max()))
        T = 8
        while T < max_len:
            T *= 2
        item_shape = ()
        for s in seqs:  # first non-empty sample defines the item shape
            if len(s):
                item_shape = s.shape[1:]
                break
        padded = np.zeros((len(seqs), T) + item_shape, dtype=self.dtype)
        for i, s in enumerate(seqs):
            if len(s):
                padded[i, :len(s)] = s
        return padded, lengths


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        from .framework import default_main_program

        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variables or names")
            self.feed_dtypes.append(np.dtype(convert_dtype(each_var.dtype))
                                    if each_var.dtype != "bfloat16" else np.float32)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        converters = [
            DataToLoDTensorConverter(self.place, lod_level, shape, dtype)
            for lod_level, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes
            )
        ]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), (
                f"sample has {len(each_sample)} slots, expected {len(converters)}"
            )
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        out = {}
        for name, conv in zip(self.feed_names, converters):
            res = conv.done()
            if isinstance(res, tuple):
                out[name], out[name + "@LEN"] = res
            else:
                out[name] = res
        return out
