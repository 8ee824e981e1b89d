"""SelectedRows — the sparse row gradient (reference
paddle/fluid/framework/selected_rows.h and
operators/math/selected_rows_functor.cc), the counterpart of
``paddle_tpu/fluid/selected_rows.py``.

  - ``rows`` is int64 [N]: one entry per lookup of the batch, duplicates
    allowed and not merged (the reference's un-merged SelectedRows);
    ``value`` is [N, ...]; ``height`` the dense dim 0 (the vocabulary).
  - The optimizer ops apply it row by row and never build the dense
    [height, ...] gradient (reference sgd_op.h, adam_op.h
    SparseAdamFunctor).
  - ``merged()`` is the reference's MergeAdd with static shapes: rows
    sorted, each unique row's sum at its first occurrence, a 0/1 mask
    over the first occurrences.
  - Not torch's sparse COO layout: its coalescing merges duplicates
    eagerly, which these semantics do not do.

Every sum over duplicate rows goes through ``index_put_(accumulate=True)``,
which sorts the indices and adds each row's terms in one fixed order on
the card as on the CPU (``index_add_`` adds with atomics on the card), so
a sparse step repeated from the same state is bitwise the same.
"""
from __future__ import annotations

import numpy as np
import torch


class SelectedRows:
    """rows: int64 [N]; value: [N, d1, ...]; height: int (dense dim 0)."""

    def __init__(self, rows, value, height: int):
        self.rows = rows
        self.value = value
        self.height = int(height)

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"value={tuple(self.value.shape)}, height={self.height})")

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    @property
    def dtype(self):
        return self.value.dtype

    def astype(self, dtype):
        return SelectedRows(self.rows, self.value.to(dtype), self.height)

    def detach(self):
        return SelectedRows(self.rows.detach(), self.value.detach(),
                            self.height)

    def to_dense(self):
        """The rows' values summed into a zero [height, ...] tensor
        (reference SelectedRows::Get); numpy for a fetched SelectedRows,
        whose fields are numpy. O(height) memory: for the paths that
        densify and for tests."""
        if isinstance(self.value, np.ndarray):
            z = np.zeros(self.dense_shape, self.value.dtype)
            np.add.at(z, np.asarray(self.rows).reshape(-1), self.value)
            return z
        z = torch.zeros(self.dense_shape, dtype=self.value.dtype,
                        device=self.value.device)
        return z.index_put_((self.rows.reshape(-1).long(),), self.value,
                            accumulate=True)

    def merged(self):
        """Duplicate rows merged with static shapes (reference MergeAdd).

        Returns ``(rows_sorted, merged_value, first_mask)``:
          - rows_sorted: the rows ascending (a stable sort), [N];
          - merged_value[i]: the sum of the values of every duplicate of
            rows_sorted[i] where i is its first occurrence, else 0;
          - first_mask: 0/1 [N] in the value's dtype, 1 at first
            occurrences.
        A scatter-add of ``first_mask * delta`` at ``rows_sorted`` is then
        exact with duplicates present (the masked entries add 0)."""
        rows = self.rows.reshape(-1).long()
        n = rows.shape[0]
        r_s, order = torch.sort(rows, stable=True)
        v_s = self.value[order]
        first = torch.ones(n, dtype=torch.bool, device=rows.device)
        first[1:] = r_s[1:] != r_s[:-1]
        seg = torch.cumsum(first, 0) - 1  # unique-row segment of each entry
        summed = torch.zeros_like(v_s).index_put_((seg,), v_s,
                                                  accumulate=True)
        firstb = first.reshape((n,) + (1,) * (self.value.ndim - 1))
        merged = torch.where(firstb, summed[seg], torch.zeros_like(v_s))
        return r_s, merged, first.to(self.value.dtype)


def is_selected_rows(x) -> bool:
    return isinstance(x, SelectedRows)


def add_any(a, b):
    """dense + dense; sparse + sparse stays sparse by concatenating the
    rows (reference sum_op keeps a SelectedRows when all its inputs are);
    mixed densifies by a scatter-add into the dense operand."""
    if is_selected_rows(a) and is_selected_rows(b):
        if a.height != b.height:
            raise ValueError(f"add_any: SelectedRows heights differ "
                             f"({a.height} vs {b.height})")
        return SelectedRows(
            torch.cat([a.rows.reshape(-1), b.rows.reshape(-1)]),
            torch.cat([a.value, b.value]), a.height)
    if is_selected_rows(a):
        a, b = b, a
    if is_selected_rows(b):
        return a.index_put((b.rows.reshape(-1).long(),),
                           b.value.to(a.dtype), accumulate=True)
    return a + b
