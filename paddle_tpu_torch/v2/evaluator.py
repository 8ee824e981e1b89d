"""reference python/paddle/v2/evaluator.py: evaluator facade — the v2
names map onto the fluid metrics/evaluator stack."""
from ..fluid.evaluator import Accuracy, ChunkEvaluator, EditDistance  # noqa: F401
from ..fluid.layers.nn import accuracy  # noqa: F401

classification_error = accuracy
