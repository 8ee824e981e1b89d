"""The sequence-lengths companion that ``fc`` and ``embedding`` carry
along (the part of ``paddle_tpu/fluid/layers/sequence.py`` they call).

Convention: a data var with lod_level > 0 is a padded dense tensor
[N, T, ...] with a companion int32 lengths var named `<name>@LEN`
(created by layers.data). Sequence-preserving layers propagate the
companion via `Variable._seq_lengths`. The sequence layers themselves are
not ported yet."""
from __future__ import annotations

from ..framework import Variable

LEN_SUFFIX = "@LEN"


def seq_lengths_of(var: Variable):
    """Resolve the lengths companion of a sequence var (or None)."""
    direct = getattr(var, "_seq_lengths", None)
    if direct is not None:
        return direct
    return var.block._var_recursive(var.name + LEN_SUFFIX)


def _propagate_lengths(src: Variable, dst: Variable):
    lens = seq_lengths_of(src)
    if lens is not None:
        dst._seq_lengths = lens
    return dst
