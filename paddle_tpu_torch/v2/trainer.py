"""v2 SGD trainer: the event-handler training loop (reference
python/paddle/v2/trainer.py SGD:37, train:137 — train_one_pass firing
BeginPass/BeginIteration/EndIteration/EndPass events)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .. import fluid
from . import event as v2_event
from .parameters import _check_device, _v2_device


def _data_var_names(block):
    """Feed placeholders in declaration order: vars that are read but never
    produced by any op and not persistable (layers.data creates these)."""
    produced = set()
    used = set()
    for op in block.ops:
        produced.update(op.desc.output_names())
        used.update(op.desc.input_names())
    return [
        n for n, v in block.vars.items()
        if n in used and n not in produced and not v.persistable
        # @LEN lengths companions ride along with their padded var — the
        # DataFeeder emits both from the one ragged sample slot
        and not n.endswith("@LEN")
    ]


class SGD:
    """The trainer runs on the v2 device (``device=``, else ``init``'s,
    else the card), which must be where ``parameters`` live."""

    def __init__(self, cost, parameters, update_equation,
                 extra_layers=None, is_local: bool = True, device=None):
        from .optimizer import _V2Optimizer

        device = _v2_device(device)
        _check_device(parameters, device)

        self.cost = cost
        self.parameters = parameters
        if isinstance(update_equation, _V2Optimizer):
            update_equation = update_equation.fluid_opt
        self._optimizer = update_equation
        self._main = parameters.main_program
        # snapshot the forward-only program BEFORE minimize appends
        # backward+optimize ops — test() must never update parameters
        self._test_prog = self._main.clone(for_test=True)
        # minimize appends backward+optimize ops once, at trainer creation
        # (the reference compiles the GradientMachine here). It also adds
        # optimizer accumulators to the startup program, which parameters
        # .create() already executed — run just the new init ops.
        from ..fluid.framework import program_guard

        with program_guard(self._main, parameters.startup_program):
            self._optimizer.minimize(self.cost)
        self._exe = fluid.Executor(device)
        self._init_missing_vars()

    def _init_missing_vars(self):
        scope = self.parameters.scope
        startup = self.parameters.startup_program
        block = startup.global_block()
        if all(scope.has_var(o) for op in block.ops
               for o in op.desc.output_names()):
            return
        pruned = startup.clone()
        # clone preserves op order — keep (positionally) only the ops whose
        # outputs aren't in scope yet
        pruned.global_block().ops = [
            cop for cop, orig in zip(pruned.global_block().ops, block.ops)
            if any(not scope.has_var(o) for o in orig.desc.output_names())
        ]
        with fluid.scope_guard(scope):
            self._exe.run(pruned)

    def _feeder(self, feeding: Optional[Dict[str, int]]):
        block = self._main.global_block()
        if feeding is None:
            # feed order = declaration order of data vars (consumed but
            # never produced, non-persistable)
            names = _data_var_names(block)
        else:
            names = [n for n, _ in sorted(feeding.items(),
                                          key=lambda kv: kv[1])]
        feed_list = [block.var(n) for n in names]
        return fluid.DataFeeder(place=None, feed_list=feed_list)

    def train(self, reader, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None):
        """reader yields minibatches (lists of samples). Fires v2 events."""
        event_handler = event_handler or (lambda e: None)
        feeder = self._feeder(feeding)
        with fluid.scope_guard(self.parameters.scope):
            for pass_id in range(num_passes):
                event_handler(v2_event.BeginPass(pass_id))
                for batch_id, data in enumerate(reader()):
                    event_handler(v2_event.BeginIteration(pass_id, batch_id))
                    (loss,) = self._exe.run(
                        self._main, feed=feeder.feed(data),
                        fetch_list=[self.cost],
                    )
                    event_handler(v2_event.EndIteration(
                        pass_id, batch_id, float(np.asarray(loss).ravel()[0])
                    ))
                event_handler(v2_event.EndPass(pass_id))

    def test(self, reader, feeding: Optional[Dict[str, int]] = None):
        feeder = self._feeder(feeding)
        costs = []
        with fluid.scope_guard(self.parameters.scope):
            for data in reader():
                (loss,) = self._exe.run(self._test_prog,
                                        feed=feeder.feed(data),
                                        fetch_list=[self.cost])
                costs.append(float(np.asarray(loss).ravel()[0]))
        return v2_event.TestResult(float(np.mean(costs)) if costs else 0.0)
