"""Typed checkpoint errors, kept apart from the on-disk format so the
serving client can map them back from the wire without importing it.
The whole package raises these two types."""
from __future__ import annotations

from typing import Optional

__all__ = ["CheckpointError", "CheckpointCorruptError"]


class CheckpointError(IOError):
    """A checkpoint artifact is missing, unreadable, or structurally
    wrong (bad format version, unknown tensor set). Typed so serving
    deploy paths surface it as-is instead of a deep KeyError."""


class CheckpointCorruptError(CheckpointError):
    """A specific tensor's bytes failed verification (crc mismatch or
    truncation). Carries ``tensor`` — the load path names the victim
    instead of letting a garbled weight surface as a shape error three
    layers into the model."""

    def __init__(self, msg: str, tensor: Optional[str] = None):
        super().__init__(msg)
        self.tensor = tensor
