"""Basis decode and the prediction / timing passes."""
