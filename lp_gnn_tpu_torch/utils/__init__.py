"""Serialization and small host-side helpers."""
from .timer import Timer, timed
