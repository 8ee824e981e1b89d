"""reference python/paddle/v2/minibatch.py — re-exports the package-level
batch() combinator."""
from .. import batch  # noqa: F401
