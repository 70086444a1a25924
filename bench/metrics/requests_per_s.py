"""Requests completed in the window over the window (host clock)."""


def read(rec):
    return rec.requests / rec.window_s if rec.requests else None
