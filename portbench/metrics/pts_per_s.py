"""Grid points of all requests completed in the window, over the window
(host clock)."""


def read(run):
    return run.points / run.window_s
