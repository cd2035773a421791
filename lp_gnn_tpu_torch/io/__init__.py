"""Basis file formats."""
