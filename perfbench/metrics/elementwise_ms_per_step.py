"""Device ms a step of everything that is not the SpMM, a GEN
aggregation kernel, a GEMM or the optimizer: casts, activations,
dropout, norms, the loss, copies (``trace.categorize``'s "other"
kind)."""


def read(tr):
    if not tr.device_ops or tr.steps <= 0:
        return None
    return 1e3 * tr.device_s("other") / tr.steps
