"""The SpMM's share of its roofline: the read-once bound of the
aggregations the profiled steps needed (``counts/``), over the device
time of the ``spmm_csr`` kernels in them."""
from . import roofline_pct


def read(tr):
    return roofline_pct(tr, ("spmm",), "spmm_csr")
