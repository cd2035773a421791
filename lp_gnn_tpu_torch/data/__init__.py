"""Processed LP blobs and their graph tensors on a device."""
