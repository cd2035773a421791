"""Solver-log parsing and the results table."""
