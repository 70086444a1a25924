"""Set-up: from process start to the first timed request (host clock)."""


def read(rec):
    return rec.setup_s
