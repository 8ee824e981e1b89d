"""Datasets (reference python/paddle/dataset/) — copies of the JAX
package's ``paddle_tpu/dataset`` modules that the port's paths read:
``uci_housing``, ``mnist``, ``cifar``, ``imdb``, ``wmt14``, ``imikolov``,
``movielens``, ``conll05``, ``flowers``, ``mq2007``, ``sentiment``,
``voc2012`` and ``wmt16``.

Nothing is downloaded. Each module serves the real files when they lie
under the same data home as the JAX package's (env ``PADDLE_TPU_DATA``),
and otherwise the same deterministic synthetic samples, so both packages
read the same data.
"""
from . import (cifar, conll05, flowers, imdb, imikolov, mnist,  # noqa: F401
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "wmt14", "imikolov",
           "movielens", "conll05", "flowers", "mq2007", "sentiment",
           "voc2012", "wmt16"]
