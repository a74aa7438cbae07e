"""Every CUDA kernel in the traced stretch, torch's own included, per frame
of the stretch's requests."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    n = len(run.trace.kernels())
    return n / run.trace.frames if n else None
