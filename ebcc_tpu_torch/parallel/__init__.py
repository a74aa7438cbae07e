"""Scale-out of the port: chunk batches over the CUDA devices of a process
(``sharded``) and chunk runs over the ranks of a ``torch.distributed``
group (``multihost``)."""

from . import mesh, multihost, sharded  # noqa: F401
from .dryrun import dryrun_multidevice  # noqa: F401
from .mesh import batch_sharding, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    decode_chunked_sharded,
    encode_chunked_sharded,
    global_range,
)
