"""Core types: places, data types, var types — the counterpart of
``paddle_tpu/fluid/core.py`` for PyTorch.

Data types keep their names (``'float32'``, ``'int64'``, ``'bfloat16'``,
...) in the Program IR and map to ``torch`` dtypes at run time. A place
maps to a ``torch.device``: ``CPUPlace`` to the CPU, ``CUDAPlace(i)`` to
card ``i``. ``default_place()`` is the card and raises without one — the
CPU runs only when the caller names it (``TPUPlace`` is not ported).
"""
from __future__ import annotations

import contextlib
import enum
import threading

import numpy as np
import torch

from ..device import resolve_device


class VarType(enum.Enum):
    # mirrors framework.proto VarType.Type (reference framework.proto:94)
    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    READER = "reader"
    RAW = "raw"


_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bfloat16": "bfloat16",
}

_TORCH_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype) -> str:
    """The IR name of a dtype given as a name, a numpy dtype or a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return _NAMES[dtype]
    if isinstance(dtype, str):
        dtype = _DTYPE_ALIASES.get(dtype, dtype)
        return str(np.dtype(dtype)) if dtype != "bfloat16" else "bfloat16"
    if getattr(dtype, "name", None) == "bfloat16":
        return "bfloat16"
    return str(np.dtype(dtype))


def as_torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]


class Place:
    """Device placement tag (reference place.h:25); ``device`` is the
    ``torch.device`` it names."""

    def __repr__(self):
        return f"{type(self).__name__}()"

    def __eq__(self, other):
        return type(self) is type(other) and getattr(self, "device_id", 0) \
            == getattr(other, "device_id", 0)

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "device_id", 0)))


class CPUPlace(Place):
    @property
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    @property
    def device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")


def default_place() -> Place:
    """The card; raises when there is none (pass ``CPUPlace()`` to run on
    the CPU)."""
    resolve_device(None)
    return CUDAPlace(0)


def as_device(place) -> torch.device:
    """A place, a ``torch.device`` or a device string -> torch.device
    (``None`` -> the card, or a raise)."""
    if place is None:
        return default_place().device
    if isinstance(place, Place):
        return place.device
    return resolve_device(place)


class GlobalSwitch:
    """A process-wide torch setting held at one value while any holder is
    inside ``held()``: the value it had before the first holder entered
    comes back when the last one leaves. Holders in several threads share
    one hold, so one thread's exit cannot release another's."""

    def __init__(self, get, set_, value):
        self._get, self._set, self._value = get, set_, value
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def held(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._get()
                self._set(self._value)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._set(self._saved)


def _get_tf32():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


def _set_tf32(value):
    torch.set_float32_matmul_precision(value[0])
    torch.backends.cudnn.allow_tf32 = value[1]


# full float32 products in cuBLAS and cuDNN (TF32 off): what the JAX
# package's matmul_precision='highest' asks of XLA
FULL_FLOAT32 = GlobalSwitch(_get_tf32, _set_tf32, ("highest", False))

# cuBLAS reduces the partial sums of a bfloat16 product in float32 and
# rounds once (PyTorch's default lets it reduce in bfloat16): what XLA
# does with a bfloat16 dot, whatever the matmul precision
F32_BF16_REDUCTION = GlobalSwitch(
    lambda: torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    lambda v: setattr(torch.backends.cuda.matmul,
                      "allow_bf16_reduced_precision_reduction", v), False)

# cuDNN picks only deterministic convolution algorithms
DETERMINISTIC_CUDNN = GlobalSwitch(
    lambda: torch.backends.cudnn.deterministic,
    lambda v: setattr(torch.backends.cudnn, "deterministic", v), True)
