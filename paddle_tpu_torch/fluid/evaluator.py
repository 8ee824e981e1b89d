"""Graph-building evaluators (reference python/paddle/fluid/evaluator.py):
each evaluator appends metric ops + persistable state vars to the main
program; `reset()` runs a small generated program zeroing the states;
`eval()` runs a generated program computing the final value from states.
A copy of ``paddle_tpu/fluid/evaluator.py``: the programs run on the
executor the caller passes."""
from __future__ import annotations

import numpy as np

from . import unique_name
from .framework import Program, Variable, program_guard
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "Accuracy", "EditDistance", "ChunkEvaluator"]


def _clone_var_(block, var):
    return block.create_var(
        name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
    )


class Evaluator:
    """Base: subclasses create state vars via `create_state` and append
    update ops in __init__ (reference evaluator.py:31)."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                assert isinstance(var, Variable)
                g_var = _clone_var_(reset_program.current_block(), var)
                zeros = reset_program.current_block().create_var(
                    name=unique_name.generate("zeros"),
                    shape=g_var.shape, dtype=g_var.dtype,
                )
                reset_program.current_block().append_op(
                    type="fill_constant",
                    outputs={"Out": [zeros]},
                    attrs={"shape": list(g_var.shape), "value": 0.0,
                           "dtype": str(g_var.dtype)},
                )
                reset_program.current_block().append_op(
                    type="assign", inputs={"X": [zeros]},
                    outputs={"Out": [g_var]},
                )
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_global_variable(
            name=unique_name.generate(f"{self.helper.name}_{suffix}"),
            persistable=True, dtype=dtype, shape=list(shape),
        )
        self.helper.set_variable_initializer(state, ConstantInitializer(0.0))
        state.stop_gradient = True
        self.states.append(state)
        return state


class Accuracy(Evaluator):
    """Running accuracy over minibatches (reference evaluator.py:117)."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total = self.create_state(dtype="int64", shape=[1], suffix="total")
        self.correct = self.create_state(
            dtype="int64", shape=[1], suffix="correct"
        )
        from .layers import nn, tensor

        total = self.helper.create_variable_for_type_inference(dtype="int32")
        correct = self.helper.create_variable_for_type_inference(dtype="int32")
        acc = nn.accuracy(
            input=input, label=label, k=k, correct=correct, total=total
        )
        total = tensor.cast(total, "int64")
        correct = tensor.cast(correct, "int64")
        tensor.sums(input=[self.total, total], out=self.total)
        tensor.sums(input=[self.correct, correct], out=self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        with program_guard(main_program=eval_program):
            total = _clone_var_(block, self.total)
            correct = _clone_var_(block, self.correct)
            from .layers import tensor

            total_f = tensor.cast(total, "float32")
            correct_f = tensor.cast(correct, "float32")
            out = correct_f / total_f
        (result,) = executor.run(eval_program, fetch_list=[out])
        return np.asarray(result)


class EditDistance(Evaluator):
    """Running average edit distance + instance error rate
    (reference evaluator.py:168)."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total_distance = self.create_state(
            dtype="float32", shape=[1], suffix="total_distance"
        )
        self.seq_num = self.create_state(
            dtype="int64", shape=[1], suffix="seq_num"
        )
        self.instance_error = self.create_state(
            dtype="int64", shape=[1], suffix="instance_error"
        )
        from .layers import nn, tensor

        distances, seq_num = nn.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens
        )
        zero = tensor.fill_constant(shape=[1], value=0.0, dtype="float32")
        compare_result = self.helper.create_variable_for_type_inference("bool")
        self.helper.append_op(
            type="greater_than",
            inputs={"X": [distances], "Y": [zero]},
            outputs={"Out": [compare_result]},
            attrs={"axis": -1},
        )
        compare_f = tensor.cast(compare_result, "float32")
        instance_error = nn.reduce_sum(compare_f)
        instance_error = tensor.cast(instance_error, "int64")
        total_distance = nn.reduce_sum(distances)
        seq_num = tensor.cast(seq_num, "int64")
        tensor.sums(
            input=[self.total_distance, total_distance],
            out=self.total_distance,
        )
        tensor.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        tensor.sums(
            input=[self.instance_error, instance_error],
            out=self.instance_error,
        )
        self.metrics.append(total_distance)
        self.metrics.append(instance_error)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        with program_guard(main_program=eval_program):
            total_distance = _clone_var_(block, self.total_distance)
            seq_num = _clone_var_(block, self.seq_num)
            instance_error = _clone_var_(block, self.instance_error)
            from .layers import tensor

            seq_num_f = tensor.cast(seq_num, "float32")
            instance_error_f = tensor.cast(instance_error, "float32")
            avg_distance = total_distance / seq_num_f
            avg_instance_error = instance_error_f / seq_num_f
        result = executor.run(
            eval_program, fetch_list=[avg_distance, avg_instance_error]
        )
        return np.asarray(result[0]), np.asarray(result[1])


class ChunkEvaluator(Evaluator):
    """Running chunking P/R/F1 from the chunk_eval op
    (reference evaluator.py:232)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, seq_length=None, **kwargs):
        super().__init__("chunk_eval", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.num_infer_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_infer_chunks"
        )
        self.num_label_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_label_chunks"
        )
        self.num_correct_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_correct_chunks"
        )
        from .layers import nn, tensor

        (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
         num_correct_chunks) = nn.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types,
            seq_length=seq_length,
        )
        tensor.sums(
            input=[self.num_infer_chunks, num_infer_chunks],
            out=self.num_infer_chunks,
        )
        tensor.sums(
            input=[self.num_label_chunks, num_label_chunks],
            out=self.num_label_chunks,
        )
        tensor.sums(
            input=[self.num_correct_chunks, num_correct_chunks],
            out=self.num_correct_chunks,
        )
        self.metrics.extend((precision, recall, f1_score))

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        with program_guard(main_program=eval_program):
            num_infer_chunks = _clone_var_(block, self.num_infer_chunks)
            num_label_chunks = _clone_var_(block, self.num_label_chunks)
            num_correct_chunks = _clone_var_(block, self.num_correct_chunks)
        num_infer, num_label, num_correct = executor.run(
            eval_program,
            fetch_list=[num_infer_chunks, num_label_chunks, num_correct_chunks],
        )
        num_infer = float(np.asarray(num_infer).reshape(-1)[0])
        num_label = float(np.asarray(num_label).reshape(-1)[0])
        num_correct = float(np.asarray(num_correct).reshape(-1)[0])
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (
            2 * precision * recall / (precision + recall) if num_correct else 0.0
        )
        return (
            np.array([precision], dtype="float32"),
            np.array([recall], dtype="float32"),
            np.array([f1], dtype="float32"),
        )
