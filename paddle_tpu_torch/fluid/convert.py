"""Carry state across from the JAX package: ``params_from_jax`` fills the
port's scope from the arrays of a JAX ``Scope`` (read out as numpy after
its startup program ran), so both packages compute from the same
parameters. Names match because both build programs with the same
``unique_name`` scheme."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import core
from .executor import Scope, global_scope


def params_from_jax(arrays: Mapping[str, np.ndarray], scope: Scope = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` -> tensors on ``device`` (``None`` = the
    card, or a raise), each set in ``scope`` (default: the global scope)
    under its name. Dtypes carry over unchanged. Returns the tensors."""
    scope = scope if scope is not None else global_scope()
    dev = core.as_device(device)
    out = {}
    for name, arr in arrays.items():
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
        scope.set_var(name, t)
        out[name] = t
    return out
