"""Bitplane quantization, cut reconstruction and coded-size estimate, plain
PyTorch.

Counterpart of ``ebcc_tpu/ops/bitplane.py:32-165`` (the dense plane packers
are host work in the port: ``core.codec.build_layer_payload_sparse``).  The
estimate of a CUDA tensor runs as one kernel pass
(``ops.bitplane_hopper``), bit-equal to :func:`estimated_code_bytes_plain`.
"""

from __future__ import annotations

import torch


def quantize_floor(coeffs):
    """Truncation toward zero -> int32 (reference ``quantize_floor``)."""
    return torch.trunc(coeffs).to(torch.int32)


def reconstruct_at_cut(q, cut):
    """Dequantized float coefficients when planes below bit ``cut`` are
    dropped: midpoint of the retained interval (+0.5 at cut 0) for
    significant values, zero otherwise, sign restored.  ``cut`` is an int32
    tensor broadcastable against ``q``.  Every step is exact in float32 for
    ``|q| < 2**23``."""
    mag = q.abs()
    kept = (mag >> cut) << cut
    significant = kept > 0
    offset = torch.where(cut > 0, (1 << cut) >> 1, 0)
    recon = (kept.to(torch.float32)
             + torch.where(significant, offset, 0).to(torch.float32)
             + torch.where(significant & (cut == 0), 0.5, 0.0))
    return torch.where(q < 0, -recon, recon)


def plane_bit_density(q, num_planes: int):
    """Fraction of 1-bits per magnitude plane, MSB first:
    ``(num_planes, ...)`` float32 over the trailing two axes."""
    mag = q.abs()
    n = q.shape[-1] * q.shape[-2]
    dens = [((mag >> p) & 1).sum(dim=(-1, -2)).to(torch.float32) / n
            for p in range(num_planes - 1, -1, -1)]
    return torch.stack(dens, dim=0)


def estimated_code_bytes(q, num_planes: int, zstd_efficiency: float = 1.35):
    """:func:`estimated_code_bytes_plain` of q: a CPU tensor takes it, any
    other the kernel of ``ops.bitplane_hopper``, which is bit-equal to it on
    the same card (and raises on what it does not take)."""
    if q.device.type == "cpu":
        return estimated_code_bytes_plain(q, num_planes, zstd_efficiency)
    from . import bitplane_hopper
    return bitplane_hopper.estimated_code_bytes(q, num_planes,
                                                zstd_efficiency)


def estimated_code_bytes_plain(q, num_planes: int,
                               zstd_efficiency: float = 1.35):
    """Estimated entropy-coded size (bytes) of the stream cut at each plane:
    ``(num_planes + 1, ...)`` float32, index k = size when cutting at bit k.

    The kept planes' entropies are summed one plane at a time (a fixed
    order, so a chunk's estimate does not depend on how many chunks share
    the batch)."""
    mag = q.abs()
    dens = plane_bit_density(q, num_planes)  # MSB first
    n = q.shape[-1] * q.shape[-2]
    eps = 1e-12
    ent = -(dens * torch.log2(dens + eps)
            + (1 - dens) * torch.log2(1 - dens + eps))
    plane_bits = ent * n
    zero = torch.zeros(q.shape[:-2], dtype=torch.float32, device=q.device)
    # prefix[k] = sum of the first k (MSB-first) plane rows.
    prefix = [zero]
    for p in range(num_planes):
        prefix.append(prefix[-1] + plane_bits[p])
    sizes = []
    for cutbit in range(num_planes + 1):
        if cutbit < num_planes:
            keep = prefix[num_planes - cutbit]
            sig = (mag >> cutbit).to(torch.bool).sum(dim=(-1, -2)).to(
                torch.float32)
        else:
            keep = sig = zero
        sizes.append((keep + sig) / 8.0 * zstd_efficiency)
    return torch.stack(sizes, dim=0)
