"""Training events (reference python/paddle/v2/event.py)."""
from __future__ import annotations


class WithMetric:
    def __init__(self, evaluator=None):
        self.evaluator = evaluator


class BeginPass:
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id: int, evaluator=None):
        super().__init__(evaluator)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id: int, batch_id: int, cost: float,
                 evaluator=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class TestResult(WithMetric):
    def __init__(self, cost: float, evaluator=None):
        super().__init__(evaluator)
        self.cost = cost
