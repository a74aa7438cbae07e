"""Raw float32 bytes over container bytes, over every write request of the
window; nothing for a cell that writes nothing."""


def read(run):
    if run.op != "write" or not run.out_bytes:
        return None
    return run.raw_bytes / run.out_bytes
