"""v2 Topology: the serialized-model-graph object (reference
python/paddle/v2/topology.py — wraps the ModelConfig proto built by
trainer/config_parser.py from the layer DSL; v2 ships it to trainers and
serializes it with parameters for inference).

Here the "config proto" is the fluid ProgramDesc the DSL built: Topology
prunes the default main program to the requested output layers (dropping
cost/backward/optimizer ops — the reference's serialize_for_inference
contract), serializes it (proto.py byte format) with the feed/fetch
metadata, and round-trips back to an executable inference program.
"""
from __future__ import annotations

import json
from typing import List

from .. import fluid
from ..fluid.framework import Program, Variable
from ..fluid.io import _prune_for_inference
from .trainer import _data_var_names


class Topology:
    def __init__(self, layers, extra_layers=None):
        if isinstance(layers, Variable):
            layers = [layers]
        self.layers: List[Variable] = list(layers)
        if extra_layers:
            self.layers += list(extra_layers)
        # prune to the output layers: the shipped graph is inference-only
        # even when the builder's default program has grown cost/optimizer
        # ops (reference serialize_for_inference)
        self.main_program = _prune_for_inference(
            fluid.default_main_program(), [], self.layers)
        self.startup_program = fluid.default_startup_program()
        self.layers = [self.main_program.global_block().var(v.name)
                       for v in self.layers]

    # -- introspection (reference Topology.get_layer / data_layers) -------
    def output_names(self) -> List[str]:
        return [v.name for v in self.layers]

    def data_names(self) -> List[str]:
        return _data_var_names(self.main_program.global_block())

    # -- serialization (reference Topology.serialize_for_inference) -------
    def serialize(self) -> bytes:
        meta = {
            "output_names": self.output_names(),
            "data_names": self.data_names(),
        }
        blob = {
            "meta": meta,
            "main_hex": self.main_program.to_bytes().hex(),
            "startup_hex": self.startup_program.to_bytes().hex(),
        }
        return json.dumps(blob).encode("utf-8")

    def serialize_for_inference(self, stream):
        stream.write(self.serialize())

    @classmethod
    def deserialize(cls, data: bytes) -> "Topology":
        blob = json.loads(data.decode("utf-8"))
        topo = cls.__new__(cls)
        topo.main_program = Program.parse_from_bytes(
            bytes.fromhex(blob["main_hex"]))
        topo.startup_program = Program.parse_from_bytes(
            bytes.fromhex(blob["startup_hex"]))
        block = topo.main_program.global_block()
        topo.layers = [block.var(n) for n in blob["meta"]["output_names"]]
        return topo

    def proto(self):
        """The underlying serializable desc (reference returns the
        ModelConfig protobuf)."""
        return self.main_program.desc
