"""Seconds from the start of the process to the start of the window:
imports, kernel builds and loads (on a checkout's first run), the slab pool,
the read cells' containers and the warm-up requests (host clock)."""


def read(run):
    return run.setup_s
