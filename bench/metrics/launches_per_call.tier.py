"""Device operations (kernels, copies, memsets) a call in the traced window."""


def read(rec):
    if rec.trace is None or not rec.steps:
        return None
    return len(rec.trace.events) / rec.steps
