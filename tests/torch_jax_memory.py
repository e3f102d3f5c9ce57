"""Memory hygiene for the port's tests in a process shared with jpegtpu's.

XLA:CPU keeps every program that jpegtpu's interpret-mode chains compile,
and glibc keeps the heap that compiling them freed. A test worker that
runs both packages' tests grows by gigabytes and holds them while it
waits for the rest of the run; six such workers can exhaust a machine's
memory. Each port test file imports `release_jax_memory`, an autouse
fixture: after a test, in a process past `RSS_LIMIT_MB`, it drops JAX's
compiled programs (later calls reload them from the persistent cache that
tests/conftest.py sets) and returns the freed heap to the system. On a
machine without JAX (the card's) it does nothing.

The same workers share the machine's cores, so the fixture also runs each
port test with one torch intra-op thread: with one thread per core in
every worker, torch's OpenMP threads wait on each other at every
parallel region, and a plain-version encode that takes 0.5 s alone took
40 s beside five busy processes (1.9 s with one thread).
"""
import ctypes
import gc
import os
import sys

import pytest
import torch

RSS_LIMIT_MB = 1024


def rss_mb():
    """Resident set of this process in MiB (0 where /proc is missing)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return 0
    return pages * os.sysconf("SC_PAGE_SIZE") >> 20


def release():
    """Drop JAX's compiled programs and trim the heap, if JAX is loaded."""
    jax = sys.modules.get("jax")
    if jax is None:
        return
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(autouse=True)
def release_jax_memory():
    torch.set_num_threads(1)
    yield
    if rss_mb() > RSS_LIMIT_MB:
        release()
