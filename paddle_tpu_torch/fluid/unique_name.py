"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import collections
import contextlib


class UniqueNameGenerator:
    def __init__(self):
        self.ids = collections.defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
