"""Launch tallies of the kernel routers, one entry per kernel."""
from __future__ import annotations

from typing import Dict

__all__ = ["LaunchCounts"]


class LaunchCounts:
    """``kernel_launches[name]`` counts launches of kernel ``name`` on a
    card; ``plain_calls[name]`` counts calls of its plain PyTorch version
    through the router (a CPU tensor). Plain ints: each kernel has one
    calling thread (the decode engine's scheduler, or the executor's
    caller)."""

    def __init__(self, *names: str):
        self.names = names
        self.reset()

    def reset(self):
        self.kernel_launches: Dict[str, int] = dict.fromkeys(self.names, 0)
        self.plain_calls: Dict[str, int] = dict.fromkeys(self.names, 0)
