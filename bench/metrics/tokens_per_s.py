"""Prompt and generated tokens of the calls completed in the window over
the window (host clock)."""


def read(rec):
    return rec.tokens / rec.window_s if rec.tokens else None
