"""The trained JAX RAR system that the port's system tests hold the port
to, trained at most once per cache however many test processes ask.

``repro.experiments.setup.build_system`` trains the system (minutes of
CPU) when its cache (``.cache/rar_system/``) is empty and writes the
cache atomically at the end. Test files that run in parallel processes
would each train it at once. :func:`jax_system` takes an exclusive lock
on a file beside the cache around the build: one process trains and
writes the cache, the others wait and then load it."""
import fcntl
import os

from repro.experiments import setup as jsetup


def jax_system():
    os.makedirs(jsetup.CACHE_DIR, exist_ok=True)
    with open(os.path.join(jsetup.CACHE_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return jsetup.build_system(verbose=False)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
