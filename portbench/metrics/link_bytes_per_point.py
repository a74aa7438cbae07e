"""Bytes the program moved over the host-device link, both ways
(``core/transfer.py`` ``LINK_STATS``), per grid point of the window."""


def read(run):
    if not run.points:
        return None
    return (run.link_up + run.link_down) / run.points
