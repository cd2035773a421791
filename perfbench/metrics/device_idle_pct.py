"""The card's idle share of the profiled span: 1 - (the union of its
kernels', copies' and sets' intervals) / the span."""


def read(tr):
    if not tr.device_ops or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.span_s)
