"""In-Python graph builder: Program / Block / Operator / Variable / Parameter
— the counterpart of ``paddle_tpu/fluid/framework.py``.

Capability-parity with the reference's `python/paddle/fluid/framework.py`
(Variable:117, Operator:361, Block:658, Program:1004, Parameter:1182,
default_main_program:1251, program_guard:1293): layer functions append OpDescs
to an implicit pair of global programs (startup = initializers, main =
training).

  - Shape/dtype inference runs the op's PyTorch emitter on ``meta``
    tensors (no data, no device), so one definition serves build-time
    inference AND execution. Unknown batch dims (-1) flow through as a
    marker extent, as in the JAX package.
  - The serialized form is proto.ProgramDesc (see proto.py): a
    ``Program.to_bytes()`` written by the JAX package loads here
    (``Program.parse_from_bytes``) and the other way round.
"""
from __future__ import annotations

import contextlib
import copy
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from . import core, unique_name
from .proto import BlockDesc, OpDesc, ProgramDesc, VarDesc
from .registry import OPS, RNG_SEED_ATTR, EmitCtx, normalize_outs

GRAD_SUFFIX = "@GRAD"

# prime marker used to flow unknown (-1) extents through meta-tensor
# inference (the JAX package's value)
_DIM_MARKER = 2477

# op types whose broken emitters were already reported at build time
_infer_shape_warned: set = set()


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """Graph variable (reference framework.py:117). Holds the static desc;
    runtime values live in a Scope as torch tensors."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        type: core.VarType = core.VarType.LOD_TENSOR,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.desc = VarDesc(
            name=name,
            type=type.value if isinstance(type, core.VarType) else str(type),
            dtype=core.convert_dtype(dtype),
            shape=list(shape) if shape is not None else None,
            lod_level=lod_level,
            persistable=persistable,
            stop_gradient=stop_gradient,
        )
        self.op: Optional["Operator"] = None  # producer, set by append_op

    # --- desc accessors -------------------------------------------------
    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, p: bool):
        self.desc.persistable = bool(p)

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, s: bool):
        self.desc.stop_gradient = bool(s)

    def __repr__(self):
        return (
            f"Variable(name={self.name}, shape={self.shape}, dtype={self.dtype},"
            f" persistable={self.persistable})"
        )

    __str__ = __repr__

    # numpy-ish sugar is monkey-patched in layers/math_op_patch.py


class Parameter(Variable):
    """Trainable persistable variable (reference framework.py:1182)."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **kwargs)
        self.desc.is_parameter = True
        self.desc.trainable = bool(self.trainable)


class Operator:
    """Appends an OpDesc and runs emitter-based shape inference
    (reference framework.py:361)."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        attrs = dict(attrs or {})
        in_names = self._normalize(inputs)
        out_names = self._normalize(outputs)

        info = OPS.get(type)
        if info is not None and info.needs_rng and RNG_SEED_ATTR not in attrs:
            # per-program counter so two identical graph builds draw identical
            # randomness under the same program.random_seed
            block.program._op_seed_counter += 1
            attrs[RNG_SEED_ATTR] = block.program._op_seed_counter

        self.desc = OpDesc(type=type, inputs=in_names, outputs=out_names, attrs=attrs)
        if info is not None:
            self._infer_shapes(info)

    @staticmethod
    def _normalize(io: Optional[Dict[str, Any]]) -> Dict[str, List[str]]:
        norm: Dict[str, List[str]] = {}
        for slot, v in (io or {}).items():
            if v is None:
                continue
            if not isinstance(v, (list, tuple)):
                v = [v]
            norm[slot] = [x.name if isinstance(x, Variable) else str(x) for x in v]
        return norm

    @property
    def type(self) -> str:
        return self.desc.type

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.desc.attrs

    def attr(self, name):
        return self.desc.attrs.get(name)

    def set_attr(self, name, val):
        self.desc.attrs[name] = val
        self.block.program._bump_version()

    def input(self, slot):
        return self.desc.inputs.get(slot, [])

    def output(self, slot):
        return self.desc.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return self.desc.input_names()

    @property
    def output_arg_names(self):
        return self.desc.output_names()

    def __repr__(self):
        return f"Operator({self.type}, {self.desc.inputs} -> {self.desc.outputs})"

    # --- shape inference via meta-tensor emitter runs ------------------
    def _infer_shapes(self, info):
        custom = info.infer_shape
        if custom is not None:
            custom(self.desc, self.block)
            return
        if any(k.endswith("_block") for k in self.desc.attrs):
            # a control-flow op resolves its sub-blocks through an
            # executor's Program; its layer sets the output shapes
            # (the JAX package's inference gives up on these ops too)
            return
        ins = {}
        for slot, names in self.desc.inputs.items():
            lst = []
            for n in names:
                if not n:
                    lst.append(None)
                    continue
                var = self.block._var_recursive(n)
                if var is None or var.shape is None:
                    return  # cannot infer
                shape = [(_DIM_MARKER if d == -1 else d) for d in var.shape]
                lst.append(torch.empty(shape, device="meta",
                                       dtype=core.as_torch_dtype(var.dtype)))
            ins[slot] = lst
        attrs = self.desc.attrs
        try:
            with torch.no_grad():
                outs = normalize_outs(
                    info.forward(EmitCtx(device="meta"), ins, attrs))
        except NotImplementedError:
            raise  # a path not yet ported: refuse the build
        except (TypeError, ValueError, RuntimeError, IndexError) as e:
            # Only a rejection of FULLY-KNOWN shapes is a genuine build-time
            # error (the reference's InferShape enforce, shape_inference.h).
            # A -1 (unknown) dim is stand-in-marked, so two different
            # unknowns can spuriously mismatch — stay silent and let run
            # time decide those.
            dims = [
                d
                for names in self.desc.inputs.values()
                for n in names if n
                for v in [self.block._var_recursive(n)]
                if v is not None and v.shape is not None
                for d in v.shape
            ]
            if any(d == -1 for d in dims):
                return
            in_desc = {
                slot: [
                    (n, tuple(self.block._var_recursive(n).shape or ()))
                    for n in names if n
                ]
                for slot, names in self.desc.inputs.items()
            }
            msg = str(e).replace(str(_DIM_MARKER), "-1(batch)")
            raise ValueError(
                f"op '{self.desc.type}' rejects its inputs at program build "
                f"time: {msg}\n  inputs: {in_desc}\n  attrs: "
                f"{ {k: v for k, v in attrs.items() if not k.startswith('__')} }"
            ) from e
        except Exception as e:
            # Anything else is an emitter bug. Surface it at build time —
            # once per op type, as a warning, or as an error under
            # FLAGS['strict_shape_inference'] (the JAX package's rule).
            from ..flags import FLAGS

            if FLAGS["strict_shape_inference"]:
                raise RuntimeError(
                    f"shape inference for op '{self.desc.type}' failed with "
                    f"an unexpected {type(e).__name__}: {e} "
                    "(strict_shape_inference is on)"
                ) from e
            if self.desc.type not in _infer_shape_warned:
                _infer_shape_warned.add(self.desc.type)
                warnings.warn(
                    f"shape inference for op '{self.desc.type}' failed with "
                    f"an unexpected {type(e).__name__}: {e} — the emitter "
                    "likely has a bug that will resurface at run time",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return
        for slot, names in self.desc.outputs.items():
            shapes = outs.get(slot, [])
            for i, n in enumerate(names):
                if not n or i >= len(shapes) or shapes[i] is None:
                    continue
                var = self.block._var_recursive(n)
                if var is None:
                    continue
                new_shape = [
                    (-1 if d == _DIM_MARKER or d % _DIM_MARKER == 0 and d > 0 else d)
                    for d in shapes[i].shape
                ]
                var.desc.shape = new_shape
                var.desc.dtype = core.convert_dtype(shapes[i].dtype)


class Block:
    """Ordered op list + var map (reference framework.py:658)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # --- vars -----------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        param = Parameter(self, shape, dtype, **kwargs)
        self.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"var '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # --- ops ------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self._note_producers(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self._note_producers(op)
        self.program._bump_version()
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self._note_producers(op)
        self.program._bump_version()
        return op

    def _note_producers(self, op: Operator):
        for n in op.desc.output_names():
            if n and n in self.vars:
                self.vars[n].op = op

    # --- desc -----------------------------------------------------------
    def to_desc(self) -> BlockDesc:
        return BlockDesc(
            idx=self.idx,
            parent_idx=self.parent_idx,
            vars={n: copy.deepcopy(v.desc) for n, v in self.vars.items()},
            ops=[copy.deepcopy(o.desc) for o in self.ops],
        )


class Program:
    """A pair-of-blocks program (reference framework.py:1004). Holds framework
    objects as source of truth; `.desc` serializes to proto.ProgramDesc."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._rng_tick = 0  # per-program run counter for seeded determinism
        self._op_seed_counter = 0  # per-program op seed assignment
        self._version = 0  # bumped on any mutation; keys the executor cache
        self._op_role_var: List[str] = []

    # --- structure ------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    # --- inspection -----------------------------------------------------
    def to_string(self, throw_on_error: bool = False,
                  with_details: bool = False) -> str:
        """Readable dump of all blocks (the port has no debugger module
        yet: this is ``repr``)."""
        return repr(self)

    # --- serialization --------------------------------------------------
    @property
    def desc(self) -> ProgramDesc:
        return ProgramDesc(blocks=[b.to_desc() for b in self.blocks])

    def to_bytes(self) -> bytes:
        return self.desc.to_bytes()

    @classmethod
    def parse_from_bytes(cls, data: bytes) -> "Program":
        return _rebuild_from_desc(ProgramDesc.from_bytes(data))

    @staticmethod
    def from_desc(desc: ProgramDesc) -> "Program":
        return _rebuild_from_desc(desc)

    # --- clone / prune --------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        p = _rebuild_from_desc(self.desc)
        p.random_seed = self.random_seed
        # carry over python-side Parameter attrs the desc can't serialize
        for blk, new_blk in zip(self.blocks, p.blocks):
            for name, var in blk.vars.items():
                if isinstance(var, Parameter) and name in new_blk.vars:
                    nv = new_blk.vars[name]
                    nv.trainable = var.trainable
                    nv.regularizer = var.regularizer
                    nv.gradient_clip_attr = var.gradient_clip_attr
                    nv.optimize_attr = dict(var.optimize_attr or {})
                    nv.do_model_average = var.do_model_average
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in op.desc.attrs:
                        op.desc.attrs["is_test"] = True
        return p

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"block {blk.idx} (parent {blk.parent_idx}):")
            for v in blk.vars.values():
                lines.append(f"  var {v.name}: {v.shape} {v.dtype}"
                             + (" persistable" if v.persistable else ""))
            for op in blk.ops:
                lines.append(f"  op {op.desc.type}: {op.desc.inputs} -> {op.desc.outputs}")
        return "\n".join(lines)


def _rebuild_from_desc(desc: ProgramDesc) -> Program:
    prog = Program()
    prog.blocks = []
    for bd in desc.blocks:
        blk = Block(prog, bd.idx, bd.parent_idx)
        prog.blocks.append(blk)
        for name, vd in bd.vars.items():
            if vd.is_parameter:
                var = Parameter.__new__(Parameter)
                var.trainable = vd.trainable
                var.regularizer = None
                var.gradient_clip_attr = None
                var.optimize_attr = {"learning_rate": 1.0}
                var.do_model_average = None
            else:
                var = Variable.__new__(Variable)
            var.block = blk
            var.desc = copy.deepcopy(vd)
            var.op = None
            blk.vars[name] = var
        for od in bd.ops:
            op = Operator.__new__(Operator)
            op.block = blk
            op.desc = copy.deepcopy(od)
            blk.ops.append(op)
            blk._note_producers(op)
            # keep the per-program op-seed counter ahead of any seeds carried
            # in the descs, so ops appended post-clone get fresh seeds
            carried = od.attrs.get(RNG_SEED_ATTR)
            if carried is not None:
                prog._op_seed_counter = max(prog._op_seed_counter, int(carried))
    if not prog.blocks:
        prog.blocks = [Block(prog, 0)]
    return prog


# --- implicit global programs (reference framework.py:1240-1304) ---------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
