"""Learning-rate decay schedules built as graph ops over a global step
counter (reference python/paddle/fluid/layers/learning_rate_scheduler.py —
exponential_decay:36, natural_exp_decay:73, inverse_time_decay:105,
polynomial_decay:142, piecewise_decay:192; step counter from
`autoincreased_step_counter`, nn.py:3323) — a copy of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``; the programs are
the JAX package's, byte for byte.

The schedule is part of the training program: the counter is a
persistable int64 [1] bumped by an ``increment`` op at the head of every
step, and the decay arithmetic runs as small ops on the executor's
device before the optimizer ops read the rate. The counter is int64
here, int32 in the JAX package (no x64); the schedules cast it to
float32, so the rates agree.
"""
from __future__ import annotations

from . import control_flow
from . import nn
from . import ops
from . import tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
]


def _decay_step_counter(begin=0):
    # float32 global step; the first observed value is `begin` (the counter
    # increments after the decay math reads it)
    global_step = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1
    )
    return tensor.cast(global_step, "float32")


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (global_step / decay_steps)"""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * exp(-decay_rate * (global_step / decay_steps))"""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1.0 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr / (1 + decay_rate * (global_step / decay_steps))"""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1.0 + decay_rate * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end_lr) * (1 - min(step, decay_steps)/decay_steps)^power + end_lr"""
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / float(decay_steps))
        zero_var = tensor.fill_constant(shape=[1], dtype="float32", value=0.0)
        one_var = tensor.fill_constant(shape=[1], dtype="float32", value=1.0)
        with control_flow.Switch() as switch:
            with switch.case(control_flow.equal(global_step, zero_var)):
                tensor.assign(one_var, output=div_res)
        decay_steps_var = tensor.fill_constant(
            shape=[1], dtype="float32", value=float(decay_steps)
        )
        decay_steps_f = decay_steps_var * div_res
    else:
        decay_steps_f = tensor.fill_constant(
            shape=[1], dtype="float32", value=float(decay_steps)
        )
        global_step = nn.elementwise_min(x=global_step, y=decay_steps_f)

    frac = (1.0 - global_step / decay_steps_f) ** power
    return (learning_rate - end_learning_rate) * frac + end_learning_rate


def piecewise_decay(boundaries, values):
    """Piecewise-constant schedule: values[i] while step < boundaries[i]."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _decay_step_counter()
    lr = tensor.create_global_var(
        shape=[1], value=0.0, dtype="float32", persistable=True,
        name="learning_rate",
    )
    with control_flow.Switch() as switch:
        for i in range(len(boundaries)):
            boundary_val = tensor.fill_constant(
                shape=[1], dtype="float32", value=float(boundaries[i])
            )
            value_var = tensor.fill_constant(
                shape=[1], dtype="float32", value=float(values[i])
            )
            with switch.case(control_flow.less_than(global_step, boundary_val)):
                tensor.assign(value_var, output=lr)
        last_value_var = tensor.fill_constant(
            shape=[1], dtype="float32", value=float(values[-1])
        )
        with switch.default():
            tensor.assign(last_value_var, output=lr)
    return lr


def noam_decay(d_model, warmup_steps):
    """Transformer LR: d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (post-dates the reference's scheduler set; standard for the Transformer
    NMT config the reference benchmarks)."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(x=a, y=b)
