"""Serializable program IR descs.

Capability-parity with the reference's protobuf IR
(`paddle/fluid/framework/framework.proto`: OpDesc:34, VarType:94,
BlockDesc:163, ProgramDesc:176). The descs here are plain dataclasses with a
canonical JSON byte encoding — the serialized `__model__` artifact produced by
save_inference_model round-trips through these.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

IR_VERSION = 1


@dataclasses.dataclass
class VarDesc:
    name: str
    type: str = "lod_tensor"  # VarType value
    dtype: str = "float32"
    shape: Optional[List[int]] = None
    lod_level: int = 0
    persistable: bool = False
    stop_gradient: bool = False
    is_parameter: bool = False
    trainable: bool = True
    # READER vars only: per-slot {shape, dtype, lod_level} specs (the
    # reference's VarType.ReaderDesc lod_tensor list, framework.proto:94) —
    # read_file() creates its output vars from these
    reader_slots: Optional[List[Dict[str, Any]]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VarDesc":
        return cls(**d)


@dataclasses.dataclass
class OpDesc:
    type: str
    inputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpDesc":
        return cls(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=dict(d.get("attrs", {})),
        )

    def input_names(self) -> List[str]:
        return [n for names in self.inputs.values() for n in names if n]

    def output_names(self) -> List[str]:
        return [n for names in self.outputs.values() for n in names if n]

    def rename_inputs(self, mapping: Dict[str, str]):
        if mapping:
            for slot, names in self.inputs.items():
                self.inputs[slot] = [mapping.get(n, n) for n in names]

    def rename_outputs(self, mapping: Dict[str, str]):
        if mapping:
            for slot, names in self.outputs.items():
                self.outputs[slot] = [mapping.get(n, n) for n in names]


@dataclasses.dataclass
class BlockDesc:
    idx: int = 0
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = dataclasses.field(default_factory=dict)
    ops: List[OpDesc] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [o.to_dict() for o in self.ops],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BlockDesc":
        return cls(
            idx=d["idx"],
            parent_idx=d.get("parent_idx", -1),
            vars={k: VarDesc.from_dict(v) for k, v in d.get("vars", {}).items()},
            ops=[OpDesc.from_dict(o) for o in d.get("ops", [])],
        )


@dataclasses.dataclass
class ProgramDesc:
    blocks: List[BlockDesc] = dataclasses.field(default_factory=list)
    version: int = IR_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.version, "blocks": [b.to_dict() for b in self.blocks]}

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True).encode("utf-8")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProgramDesc":
        return cls(
            blocks=[BlockDesc.from_dict(b) for b in d.get("blocks", [])],
            version=d.get("version", IR_VERSION),
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ProgramDesc":
        return cls.from_dict(json.loads(b.decode("utf-8")))
