"""v2 Parameters (reference python/paddle/v2/parameters.py — numpy-backed
parameter pool with tar serialization). The values live in a scope on
one device, as torch tensors; ``get`` and the tar speak numpy, so a tar
of the JAX package's ``Parameters`` loads here and the other way
round."""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np

from .. import fluid
from ..device import resolve_device
from ..fluid.executor import _as_feed, fetch_var

# the device paddle.v2.init() chose; None until it is called
_init_device = None


def _set_init_device(device):
    global _init_device
    _init_device = resolve_device(device)


def _v2_device(device=None):
    """The device of a v2 entry point: ``device`` when given, else the
    one ``init`` chose, else the card (a raise without one)."""
    if device is not None:
        return resolve_device(device)
    if _init_device is not None:
        return _init_device
    return resolve_device(None)


def _check_device(parameters, device):
    """``device`` must be where ``parameters`` live: a v2 trainer or
    inference never moves them on its own."""
    a, b = parameters.device, device
    if (a.type, a.index or 0) != (b.type, b.index or 0):
        raise ValueError(
            f"the parameters live on {str(parameters.device)!r} but this "
            f"v2 call runs on {str(device)!r}; pass device= or call "
            "paddle.v2.init() to choose one device for both")


class Parameters:
    """Holds the scope + programs behind a v2 topology, and the device of
    the executor that filled the scope."""

    def __init__(self, scope, main_program, startup_program, device=None):
        self.scope = scope
        self.main_program = main_program
        self.startup_program = startup_program
        self.device = _v2_device(device)

    def names(self):
        return [p.name for p in self.main_program.global_block().all_parameters()]

    def get(self, name) -> np.ndarray:
        return fetch_var(name, self.scope)

    def set(self, name, value):
        self.scope.set_var(name, _as_feed(value, self.device))

    def __iter__(self):
        return iter(self.names())

    def to_tar(self, f):
        """reference to_tar — here a pickle of name->ndarray."""
        pickle.dump({n: self.get(n) for n in self.names()}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_tar(cls, f, topology_cost=None):
        data: Dict[str, np.ndarray] = pickle.load(f)
        params = create(topology_cost)
        for n, v in data.items():
            params.set(n, v)
        return params


def create(cost=None, device=None) -> Parameters:
    """Materialize parameters for the current default programs (reference
    paddle.v2.parameters.create(cost)): runs the startup program into the
    current scope on the v2 device (see ``_v2_device``)."""
    device = _v2_device(device)
    scope = fluid.global_scope()
    exe = fluid.Executor(device)
    exe.run(fluid.default_startup_program())
    return Parameters(scope, fluid.default_main_program(),
                      fluid.default_startup_program(), device=device)
