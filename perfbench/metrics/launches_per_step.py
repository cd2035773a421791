"""Device operations launched a step: every kernel, copy and set the
profiled steps ran on the card, over those steps."""


def read(tr):
    if not tr.device_ops or tr.steps <= 0:
        return None
    return len(tr.device_ops) / tr.steps
