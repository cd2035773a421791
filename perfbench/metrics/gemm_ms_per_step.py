"""Device ms a step of the cuBLAS GEMMs (the models' Linear layers)."""


def read(tr):
    spent = tr.device_s("gemm")
    if spent <= 0 or tr.steps <= 0:
        return None
    return 1e3 * spent / tr.steps
