"""Thread seconds in the stage ``assemble+zstd`` (host stream assembly,
plane packing and zstd, ``core/codec.py`` ``_assemble_batch``) per million
grid points of the window."""

from portbench.metrics import _stages


def read(run):
    return _stages.per_mpt(run, "assemble+zstd")
