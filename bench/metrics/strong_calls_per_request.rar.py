"""Strong-tier requests (the engine's ``calls`` counter: answers and guide
generations) over the window's requests."""


def read(rec):
    n = rec.counters.get("strong_calls")
    return None if n is None or not rec.requests else n / rec.requests
