"""Datasets (reference python/paddle/dataset/) — copies of the JAX
package's ``paddle_tpu/dataset`` modules that the port's paths read:
``uci_housing``, ``mnist``, ``cifar``, ``imdb``, ``wmt14``, ``imikolov``,
``movielens`` and ``conll05``.

Nothing is downloaded. Each module serves the real files when they lie
under the same data home as the JAX package's (env ``PADDLE_TPU_DATA``),
and otherwise the same deterministic synthetic samples, so both packages
read the same data.
"""
from . import (cifar, conll05, imdb, imikolov, mnist, movielens,  # noqa: F401
               uci_housing, wmt14)

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "wmt14", "imikolov",
           "movielens", "conll05"]
