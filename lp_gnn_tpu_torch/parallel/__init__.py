"""Distributed execution: the ``edge`` mesh, the host partition with its
boundary halo lists, the halo kernels and the dist step; the ``dp``
process group and the batched step; dp x edge (``combined``)."""
