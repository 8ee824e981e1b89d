"""Graph-level control-flow layers (reference
python/paddle/fluid/layers/control_flow.py: StaticRNN:383, While:608,
ConditionalBlock:1106, Switch:1163, IfElse:1252, DynamicRNN:1354,
array_write:889, array_read:1017, less_than:953, increment) — a copy of
``paddle_tpu/fluid/layers/control_flow.py``. The programs they build are
the JAX package's, byte for byte.

Each of these layers records its sub-block and appends one op (``while``,
``conditional_block``, ``ifelse``, ``recurrent``, ``dynamic_recurrent``,
``recompute``, ``parallel_do``)
that lists every outer var the block reads as an input; the executor
runs the block eagerly (ops/control_flow.py), and every one of these
ops is differentiable.
"""
from __future__ import annotations

import contextlib

from ..layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "ConditionalBlock",
    "Switch", "Recompute", "increment", "array_write", "array_read", "array_length",
    "create_array", "less_than", "equal", "zeros_like_array", "Print",
    "lod_rank_table", "reorder_lod_tensor_by_rank", "max_sequence_len",
    "get_places", "ParallelDo",
]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="increment", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"step": float(value)},
    )
    return out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(
        type="less_than", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]},
    )
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(
        type="equal", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]},
    )
    return cond


def create_array(dtype, size, item_shape):
    """Preallocated tensor array [size, *item_shape] (the JAX package's
    form; the reference's LoDTensorArray grows dynamically)."""
    from .tensor import fill_constant

    return fill_constant(shape=[size] + list(item_shape), dtype=dtype, value=0.0)


def array_write(x, i, array):
    """Writes x at position i. As in the reference (the op's output IS the
    array variable), the write is in-place on `array`'s name — which is also
    what lets an enclosing While carry the array across iterations."""
    helper = LayerHelper("array_write")
    helper.append_op(
        type="write_to_array",
        inputs={"Array": [array], "X": [x], "I": [i]},
        outputs={"Out": [array]},
    )
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(
        type="read_from_array", inputs={"X": [array], "I": [i]},
        outputs={"Out": [out]},
    )
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="array_length", inputs={"X": [array]}, outputs={"Out": [out]},
    )
    return out


def lod_rank_table(x, level=0):
    """Index permutation sorting the batch by descending sequence length
    (reference layers/control_flow.py lod_rank_table; the LoDRankTable's
    role on the padded stack — see ops/sequence_ops.py)."""
    from .sequence import seq_lengths_of

    if level != 0:
        raise ValueError(
            "the padded stack has a single ragged level; lod_rank_table "
            f"(level={level}) has no nested-LoD equivalent")
    lens = seq_lengths_of(x)
    if lens is None:
        raise ValueError(
            "lod_rank_table needs a sequence input (padded var with a "
            "lengths companion, e.g. from layers.data(lod_level=1))")
    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference("int32")
    out.stop_gradient = True
    helper.append_op(
        type="lod_rank_table", inputs={"X": [x], "Lengths": [lens]},
        outputs={"Out": [out]},
    )
    return out


def max_sequence_len(x):
    """Max sequence length in the batch as an int64 [1] tensor (reference
    layers/control_flow.py max_sequence_len — there it reads the
    LoDRankTable; here the lengths companion of the sequence var)."""
    from .sequence import seq_lengths_of

    lens = seq_lengths_of(x)
    if lens is None:
        raise ValueError("max_sequence_len needs a sequence input "
                         "(padded var with a lengths companion)")
    helper = LayerHelper("max_sequence_len")
    # int32, as the JAX package declares it and the op computes it
    out = helper.create_variable_for_type_inference("int32")
    out.stop_gradient = True
    helper.append_op(
        type="max_sequence_len", inputs={"Lengths": [lens]},
        outputs={"Out": [out]},
    )
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Gather the batch rows into rank order; the lengths companion is
    reordered alongside (reference reorder_lod_tensor_by_rank_op.cc)."""
    from .sequence import seq_lengths_of

    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankTable": [rank_table]},
        outputs={"Out": [out]},
    )
    lens = seq_lengths_of(x)
    if lens is not None:
        new_lens = helper.create_variable_for_type_inference(lens.dtype)
        new_lens.stop_gradient = True
        helper.append_op(
            type="reorder_lod_tensor_by_rank",
            inputs={"X": [lens], "RankTable": [rank_table]},
            outputs={"Out": [new_lens]},
        )
        out._seq_lengths = new_lens
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Tensor tap (reference layers/control_flow.py Print, print_op.cc):
    returns `input` unchanged and prints stats + first `summarize` values
    whenever the op executes. `print_phase`: 'forward', 'backward', 'both'
    — backward taps the gradient flowing through. (`first_n` and the
    print_tensor_* switches are accepted for API parity; the printer
    always shows name/shape/dtype and prints every step, one device
    sync each.)"""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="print", inputs={"In": [input]}, outputs={"Out": [out]},
        attrs={
            "first_n": int(first_n),
            "message": message or input.name,
            "summarize": int(summarize),
            "print_phase": print_phase,
        },
    )
    from .sequence import _propagate_lengths

    _propagate_lengths(input, out)
    return out


def zeros_like_array(x):
    helper = LayerHelper("zeros_like")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]},
    )
    return out


def _scan_block_io(sub, parent_block):
    """Outer vars a finished sub-block touches: returns (touched, written) —
    `touched` = sorted outer-var names the block reads OR writes (write-only
    outer vars still need their pre-loop value as carry init), `written` =
    output names in first-write order."""
    read, written = set(), []
    for op in sub.ops:
        read.update(n for n in op.desc.input_names() if n)
        for n in op.desc.output_names():
            if n and n not in written:
                written.append(n)
    touched = sorted(
        n for n in (read | set(written))
        if n not in sub.vars and parent_block._var_recursive(n) is not None
    )
    return touched, written


def _outer_reads(sub, parent_block, exclude=()):
    """Outer-var names a finished sub-block READS (params + captured
    tensors), minus `exclude` (block-local placeholders like step inputs).
    Shared by DynamicRNN and Pipeline region capture."""
    read = set()
    for op in sub.ops:
        read.update(n for n in op.desc.input_names() if n)
    return sorted(
        n for n in read
        if n not in exclude
        and n not in sub.vars
        and parent_block._var_recursive(n) is not None
    )


class While:
    """reference control_flow.py:608. Usage:
        cond = layers.less_than(i, n)
        w = While(cond)                    # dynamic trip count
        w = While(cond, max_steps=K)       # known trip bound
        with w.block():
            ...ops...  (must update `cond` for termination)

    Both forms support append_backward (the reference's while grad,
    while_op.cc:96): autograd through the iterations the forward ran.
    With `max_steps` the loop runs exactly K iterations, freezing its
    carry once the condition is false — no host read of the condition;
    without it the condition is read on the host every iteration."""

    def __init__(self, cond, name=None, max_steps=None,
                 grad_segment_len=None, grad_max_segments=None):
        """`grad_segment_len` / `grad_max_segments` tune the JAX
        package's checkpointed replay of an unbounded While's gradient;
        they are kept as attrs so both packages build the same program,
        and the port (which replays nothing) does not read them."""
        self.helper = LayerHelper("while", name=name)
        if cond.dtype != "bool":
            raise TypeError("condition should be a bool variable")
        self.cond_var = cond
        self.max_steps = int(max_steps) if max_steps else 0
        self.grad_segment_len = int(grad_segment_len or 0)
        self.grad_max_segments = int(grad_max_segments or 0)

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent_block = main.current_block()
        sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
            # X = outer vars the block touches; Out = written vars with a
            # pre-loop value (the emitter's loop carry)
            touched, written = _scan_block_io(sub, parent_block)
            carried = [n for n in written
                       if n in touched or n == self.cond_var.name]
            parent_block.append_op(
                type="while",
                inputs={"Condition": [self.cond_var], "X": touched},
                outputs={"Out": carried},
                attrs={
                    "sub_block": sub.idx,
                    "x_var_names": touched,
                    "cond_var_name": self.cond_var.name,
                    "out_var_names": carried,
                    "max_steps": self.max_steps,
                    "grad_segment_len": self.grad_segment_len,
                    "grad_max_segments": self.grad_max_segments,
                },
            )


class ConditionalBlock:
    """reference control_flow.py:1106."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        assert len(inputs) == 1, "one condition var"
        self.cond_var = inputs[0]

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent_block = main.current_block()
        sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
            touched, written = _scan_block_io(sub, parent_block)
            carried = [n for n in written if n in touched]
            parent_block.append_op(
                type="conditional_block",
                inputs={"Condition": [self.cond_var], "X": touched},
                outputs={"Out": carried},
                attrs={
                    "sub_block": sub.idx,
                    "x_var_names": touched,
                    "out_var_names": carried,
                },
            )


def get_places(device_count=0, device_type=None):
    """reference layers/device.py get_places / operators/get_places_op.cc:
    a PLACE_LIST var naming the devices a ParallelDo spreads over. Here a
    place is a mesh position, so the var is an int32 [n] of device indices
    (0 = the active ParallelExecutor mesh's size at run time, else the
    count of the run's device kind). `device_type` is accepted for API
    parity and ignored — the mesh decides."""
    helper = LayerHelper("get_places")
    out = helper.create_variable_for_type_inference("int32")
    out.stop_gradient = True
    helper.append_op(
        type="get_places", inputs={}, outputs={"Out": [out]},
        attrs={"device_count": int(device_count or 0)},
    )
    return out


class ParallelDo:
    """reference layers/control_flow.py:234 + operators/parallel_do_op.cc:115
    — data-parallel region: the reference splits the batch across places,
    re-runs the sub-block per device on threads, and all-reduces grads.

    Semantics (the JAX package's): the captured sub-block runs ONCE over
    the full batch; sharding the batch axis across the mesh
    (ParallelExecutor, DTensor) then yields exactly the reference's
    split-run-allreduce — DTensor inserts the collectives. The region is
    differentiable through the generic grad op, so grads flow with no
    ParallelDo-specific grad machinery (the reference needed NCCL op
    inserts in backward.py).

    Usage (reference API):
        places = layers.get_places()
        pd = layers.ParallelDo(places)
        with pd.do():
            x_ = pd.read_input(x)
            loss = net(x_)
            pd.write_output(loss)
        loss, = pd()
    """

    def __init__(self, places, use_nccl=False, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self.places = places
        self.use_nccl = use_nccl  # parity only: collectives come from DTensor
        self._inputs = []   # (outer Variable, sub-block placeholder)
        self._outputs = []  # sub-block Variables registered by write_output
        self._sub = None
        self._parent = None
        self._result_vars = None

    def read_input(self, var):
        if self._sub is None:
            raise RuntimeError("read_input() must be called inside do()")
        placeholder = self._sub.create_var(
            name=f"{var.name}@PDO", shape=var.shape, dtype=var.dtype,
            lod_level=getattr(var, "lod_level", 0),
        )
        self._inputs.append((var, placeholder))
        return placeholder

    def write_output(self, var):
        if self._sub is None:
            raise RuntimeError("write_output() must be called inside do()")
        self._outputs.append(var)

    @contextlib.contextmanager
    def do(self):
        main = self.helper.main_program
        self._parent = main.current_block()
        self._sub = main.create_block()
        try:
            yield
        except BaseException:
            # body failed: surface the user's exception untouched; don't
            # append an op over the half-built sub-block
            main.rollback()
            raise
        else:
            main.rollback()
            if not self._outputs:
                raise ValueError("ParallelDo region wrote no outputs — "
                                 "call pd.write_output(var) inside do()")
            sub, parent = self._sub, self._parent
            placeholder_names = [p.name for _, p in self._inputs]
            reads = _outer_reads(sub, parent, exclude=placeholder_names)
            # parent-scope result vars mirror the registered sub-block vars
            # (shapes known from the traced body -> downstream layers keep
            # build-time shape inference)
            self._result_vars = [
                parent.create_var(
                    name=f"{o.name}@PDO_OUT", shape=o.shape, dtype=o.dtype,
                )
                for o in self._outputs
            ]
            parent.append_op(
                type="parallel_do",
                inputs={
                    "Places": [self.places],
                    "Inputs": [v for v, _ in self._inputs],
                    "X": reads,
                },
                outputs={"Out": self._result_vars},
                attrs={
                    "sub_block": sub.idx,
                    "input_var_names": placeholder_names,
                    "x_var_names": reads,
                    "out_var_names": [o.name for o in self._outputs],
                },
            )

    def __call__(self):
        if self._result_vars is None:
            raise RuntimeError("ParallelDo has no results — call pd() after "
                               "a completed `with pd.do():` region")
        outs = self._result_vars
        return outs[0] if len(outs) == 1 else tuple(outs)


class Switch:
    """reference control_flow.py:1163 — chained conditional blocks."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        if self.pre_not_conditions:
            helper = LayerHelper("logical_and")
            combined = helper.create_variable_for_type_inference("bool")
            helper.append_op(
                type="logical_and",
                inputs={"X": [self.pre_not_conditions[-1]],
                        "Y": [condition]},
                outputs={"Out": [combined]},
            )
            cond_to_use = combined
        else:
            cond_to_use = condition
        helper = LayerHelper("logical_not")
        not_cond = helper.create_variable_for_type_inference("bool")
        helper.append_op(
            type="logical_not", inputs={"X": [condition]},
            outputs={"Out": [not_cond]},
        )
        if self.pre_not_conditions:
            helper = LayerHelper("logical_and")
            chained = helper.create_variable_for_type_inference("bool")
            helper.append_op(
                type="logical_and",
                inputs={"X": [self.pre_not_conditions[-1]], "Y": [not_cond]},
                outputs={"Out": [chained]},
            )
            not_cond = chained
        self.pre_not_conditions.append(not_cond)
        cb = ConditionalBlock([cond_to_use])
        with cb.block():
            yield

    @contextlib.contextmanager
    def default(self):
        assert self.pre_not_conditions, "default() requires a prior case()"
        cb = ConditionalBlock([self.pre_not_conditions[-1]])
        with cb.block():
            yield

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class IfElse:
    """Per-example branch (reference control_flow.py:1252).

        ie = IfElse(cond)            # cond: bool [N, 1]
        with ie.true_block():
            d = ie.input(x)
            ie.output(layers.fc(d, ...))
        with ie.false_block():
            d = ie.input(x)
            ie.output(layers.scale(d, scale=2.0))
        out, = ie()                  # rows merged by cond

    The reference splits rows into subsets per branch (split_lod_tensor /
    merge_lod_tensor); here both branches compute on the full batch and rows
    are merged with where(cond) — see ops/control_flow.py:ifelse. Both
    branches must output() the same number of (shape-compatible) vars.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._blocks = {}     # 'true'/'false' -> (sub_block, out_names)
        self._cur = None
        self._outputs = {"true": [], "false": []}

    @contextlib.contextmanager
    def _branch(self, which):
        main = self.helper.main_program
        self._parent = main.current_block()
        sub = main.create_block()
        self._cur = which
        try:
            yield
        finally:
            main.rollback()
            self._blocks[which] = sub
            self._cur = None

    def true_block(self):
        return self._branch("true")

    def false_block(self):
        return self._branch("false")

    def input(self, x):
        """The reference returns the branch's row subset; here the branch
        computes on all rows and the merge masks — so input() is identity."""
        if self._cur is None:
            raise RuntimeError("IfElse.input() must be called inside a block")
        return x

    def output(self, *outs):
        if self._cur is None:
            raise RuntimeError("IfElse.output() must be called inside a block")
        self._outputs[self._cur].extend(outs)

    def __call__(self):
        t, f = self._outputs["true"], self._outputs["false"]
        if "true" not in self._blocks or "false" not in self._blocks:
            raise RuntimeError("IfElse needs both true_block and false_block")
        if len(t) != len(f):
            raise ValueError(
                f"IfElse branches output different counts: {len(t)} vs {len(f)}")
        parent = self._parent
        touched = set()
        for sub in self._blocks.values():
            tr, _ = _scan_block_io(sub, parent)
            touched.update(tr)
        touched.discard(self.cond.name)
        touched = sorted(touched)
        out_vars = [
            parent.create_var(
                name=self.helper.name + f".out{i}", dtype=tv.dtype,
                shape=list(tv.shape) if tv.shape else None,
            )
            for i, tv in enumerate(t)
        ]
        parent.append_op(
            type="ifelse",
            inputs={"Cond": [self.cond], "X": touched},
            outputs={"Out": out_vars},
            attrs={
                "true_block": self._blocks["true"].idx,
                "false_block": self._blocks["false"].idx,
                "x_var_names": touched,
                "cond_var_name": self.cond.name,
                "true_out_names": [v.name for v in t],
                "false_out_names": [v.name for v in f],
            },
        )
        return out_vars


class DynamicRNN:
    """Variable-length RNN over padded sequences (reference
    control_flow.py:1354), trainable.

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)       # x: [N, T, D] (+@LEN lengths)
            h_prev = drnn.memory(shape=[H], value=0.0)
            ctx_s = drnn.static_input(enc)  # per-example non-sequence input
            h = layers.fc(input=[x_t, h_prev], size=H, act='tanh')
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()                        # [N, T, H], lengths propagated

    The reference shrinks the running batch as short sequences finish
    (lod_rank_table/shrink_rnn_memory); here the step block runs over the
    static [N, T] extent with per-example masking (ops/control_flow.py:
    dynamic_recurrent) — memories freeze and outputs are zero past each
    sequence's length, so sequence_last_step() picks the true final state.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._sub = None
        self._parent = None
        self.step_inputs = []    # (full_var, step_var)
        self.static_inputs = []  # (outer_var, step_var)
        self.memories = []       # [pre_var, updated_var|None, init_var]
        self.outputs = []
        self._lengths = None
        self._out_vars = None

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        self._parent = main.current_block()
        self._sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
            self._complete()

    def step_input(self, x):
        from .sequence import seq_lengths_of

        if self._lengths is None:
            self._lengths = seq_lengths_of(x)
        sv = self._sub.create_var(
            name=x.name + "@dstep", dtype=x.dtype,
            shape=[x.shape[0]] + list(x.shape[2:]) if x.shape else None,
        )
        self.step_inputs.append((x, sv))
        return sv

    def static_input(self, x):
        sv = self._sub.create_var(
            name=x.name + "@dstatic", dtype=x.dtype,
            shape=list(x.shape) if x.shape else None,
        )
        self.static_inputs.append((x, sv))
        return sv

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        if init is None:
            if not self.step_inputs:
                raise ValueError(
                    "DynamicRNN.memory(shape=...) needs a prior step_input "
                    "(batch reference)")
            from .tensor import fill_constant_batch_size_like

            # created in the parent block, batch-matched to the sequence input
            main = self.helper.main_program
            main.current_block_idx = self._parent.idx
            try:
                init = fill_constant_batch_size_like(
                    input=self.step_inputs[0][0], shape=[-1] + list(shape),
                    dtype=dtype, value=value)
            finally:
                main.current_block_idx = self._sub.idx
        pre = self._sub.create_var(
            name=init.name + "@dpre_mem", dtype=init.dtype,
            shape=list(init.shape) if init.shape else None,
        )
        self.memories.append([pre, None, init])
        return pre

    def update_memory(self, mem, var):
        for m in self.memories:
            if m[0] is mem:
                m[1] = var
                return
        raise ValueError("update_memory: unknown memory var")

    def output(self, *outputs):
        self.outputs.extend(outputs)

    def _complete(self):
        if not self.step_inputs:
            raise ValueError("DynamicRNN needs at least one step_input")
        assert all(m[1] is not None for m in self.memories), (
            "every memory needs update_memory()")
        step_locals = {sv.name for _, sv in self.step_inputs}
        step_locals.update(sv.name for _, sv in self.static_inputs)
        step_locals.update(m[0].name for m in self.memories)
        params = _outer_reads(self._sub, self._parent, exclude=step_locals)
        self._out_vars = []
        for o in self.outputs:
            ov = self._parent.create_var(
                name=o.name + "@dseq", dtype=o.dtype,
                shape=[o.shape[0], -1] + list(o.shape[1:]) if o.shape else None,
            )
            if self._lengths is not None:
                ov._seq_lengths = self._lengths
            self._out_vars.append(ov)
        inputs = {
            "StepInputs": [x for x, _ in self.step_inputs],
            "MemInit": [m[2] for m in self.memories],
            "StaticInputs": [x for x, _ in self.static_inputs],
            "Params": params,
        }
        if self._lengths is not None:
            inputs["Lengths"] = [self._lengths]
        self._parent.append_op(
            type="dynamic_recurrent",
            inputs=inputs,
            outputs={"Out": self._out_vars},
            attrs={
                "sub_block": self._sub.idx,
                "step_input_vars": [sv.name for _, sv in self.step_inputs],
                "static_input_vars": [sv.name for _, sv in self.static_inputs],
                "memory_links": [[m[0].name, m[1].name] for m in self.memories],
                "step_output_vars": [o.name for o in self.outputs],
                "param_var_names": params,
            },
        )

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class StaticRNN:
    """reference control_flow.py:383 — define one step; the `recurrent` op
    runs it over axis 1 (differentiable).

        rnn = StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)          # x: [N, T, D] -> xt: [N, D]
            h_prev = rnn.memory(init=h0)    # h0: [N, H]
            h = layers.fc(input=[xt, h_prev], size=H, act='tanh')
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                          # [N, T, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("recurrent", name=name)
        self._sub = None
        self._parent = None
        self.step_inputs = []   # (full_seq_var, step_var)
        self.memories = []      # (pre_mem_var, mem_var_or_None, init_var)
        self.outputs = []       # step-local output vars

    @contextlib.contextmanager
    def step(self):
        main = self.helper.main_program
        self._parent = main.current_block()
        self._sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
            self._complete()

    def step_input(self, x):
        sv = self._sub.create_var(
            name=x.name + "@step", dtype=x.dtype,
            shape=[x.shape[0]] + list(x.shape[2:]) if x.shape else None,
        )
        self.step_inputs.append((x, sv))
        return sv

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        if init is None:
            raise ValueError("StaticRNN.memory requires an init var "
                             "(create it with layers.fill_constant_batch_size_like)")
        pre = self._sub.create_var(
            name=init.name + "@pre_mem", dtype=init.dtype,
            shape=list(init.shape) if init.shape else None,
        )
        self.memories.append([pre, None, init])
        return pre

    def update_memory(self, mem, var):
        for m in self.memories:
            if m[0] is mem:
                m[1] = var
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self.outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        assert all(m[1] is not None for m in self.memories), (
            "every memory needs update_memory()"
        )
        if not self.step_inputs:
            raise ValueError(
                "StaticRNN needs at least one step_input — the trip count "
                "is its time extent (axis 1)"
            )
        # params: outer vars read by step ops (weights/biases), excluding
        # step-local vars — they become explicit op inputs so the generic
        # grad differentiates through the steps
        step_locals = {sv.name for _, sv in self.step_inputs}
        step_locals.update(m[0].name for m in self.memories)
        read = set()
        for op in self._sub.ops:
            read.update(n for n in op.desc.input_names() if n)
        params = sorted(
            n for n in read
            if n not in step_locals
            and n not in self._sub.vars
            and self._parent._var_recursive(n) is not None
        )
        self._out_vars = [
            self._parent.create_var(
                name=o.name + "@seq", dtype=o.dtype,
                shape=[o.shape[0], -1] + list(o.shape[1:]) if o.shape else None,
            )
            for o in self.outputs
        ]
        self._parent.append_op(
            type="recurrent",
            inputs={
                "StepInputs": [x for x, _ in self.step_inputs],
                "MemInit": [m[2] for m in self.memories],
                "Params": params,
            },
            outputs={"Out": self._out_vars},
            attrs={
                "sub_block": self._sub.idx,
                "step_input_vars": [sv.name for _, sv in self.step_inputs],
                "memory_links": [[m[0].name, m[1].name] for m in self.memories],
                "step_output_vars": [o.name for o in self.outputs],
                "param_var_names": params,
            },
        )

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class Recompute:
    """Gradient rematerialization region (the JAX package's
    ``layers.Recompute``; the 2018 reference has no equivalent — its
    memory story is memory_optimization_transpiler reuse). Ops built
    inside ``block()`` run as one ``recompute`` op: their activations are
    NOT kept for backward; the backward pass re-runs the region instead
    (``torch.utils.checkpoint``), trading FLOPs for device memory.

        rc = layers.Recompute()
        with rc.block():
            h = layers.fc(x, size=4096, act="relu")
            h = layers.fc(h, size=4096, act="relu")
        h = rc.output(h)

    The replay draws the same dropout masks (the per-op generators of
    ``EmitCtx.rng``). Gradients equal the plain program's up to the order
    in which autograd sums a value the region fans out."""

    def __init__(self, name=None):
        self.helper = LayerHelper("recompute", name=name)
        self._sub = None
        self._parent = None

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        self._parent = main.current_block()
        self._sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()

    def output(self, *out_vars):
        """Completes the region; returns parent-block vars mirroring
        `out_vars` (one var -> one var, several -> tuple). Writes the
        region makes to OUTER vars (assign/increment into a parent var)
        are carried out as additional op outputs so post-region readers
        see the updated values."""
        if self._sub is None:
            raise RuntimeError("Recompute.output() must follow block()")
        if not out_vars:
            raise ValueError("Recompute.output() needs at least one var")
        sub, parent = self._sub, self._parent
        reads = _outer_reads(sub, parent)
        # the JAX package cannot differentiate an unbounded `while` inside
        # its checkpointed region and refuses one at build time; so does
        # the port, which builds the same programs
        for op in sub.ops:
            if op.desc.type == "while" and not op.desc.attrs.get("max_steps"):
                raise ValueError(
                    "Recompute region contains a While without max_steps — "
                    "its gradient cannot be taken inside the region; give "
                    "the loop max_steps or move it outside the region")
        produced = {n for op in sub.ops for n in op.desc.output_names() if n}
        for v in out_vars:
            if v.name not in produced and v.name not in reads:
                raise ValueError(
                    f"Recompute.output(): '{v.name}' is neither produced "
                    "nor read by the region — pass a var computed inside "
                    "block()")
        # outer vars the region writes IN PLACE: carried out name-for-name
        outer_written = [
            n for n in produced
            if n not in sub.vars and parent._var_recursive(n) is not None
        ]
        outs = []
        for i, v in enumerate(out_vars):
            outs.append(parent.create_var(
                name=f"{self.helper.name}.out{i}", dtype=v.dtype,
                shape=list(v.shape) if v.shape is not None else None,
            ))
        parent.append_op(
            type="recompute",
            inputs={"X": reads},
            outputs={"Out": outs + [parent._var_recursive(n)
                                    for n in sorted(outer_written)]},
            attrs={
                "sub_block": sub.idx,
                "x_var_names": reads,
                "out_var_names": [v.name for v in out_vars]
                                 + sorted(outer_written),
            },
        )
        return outs[0] if len(outs) == 1 else tuple(outs)
