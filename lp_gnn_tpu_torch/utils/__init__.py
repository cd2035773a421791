"""Serialization and small host-side helpers."""
