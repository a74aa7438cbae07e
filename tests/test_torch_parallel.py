"""The port's scale-out (``ebcc_tpu_torch.parallel``) against its own
unsharded container and the JAX package's, on the CPU.

Inputs are smooth 64x64 frames made with numpy from fixed seeds, in
one-frame chunks.  Meshes of CPU "devices" (``make_mesh(device="cpu",
n=k)``) stand in for a split over several cards, which a one-card
machine cannot run.

* ``host_chunk_slice`` equals the JAX package's on a grid of chunk and
  process counts, more processes than chunks included.
* ``encode_chunked_sharded`` over meshes of 1, 2 and 3 devices, on 5
  chunks (uneven runs) and 2 (fewer chunks than devices), in MAX_ERROR,
  rate and lossless mode (and POINTWISE with ``allow_nan`` and temporal on
  2 devices): the container is byte-identical to the port's
  ``encode_chunked``, and ``decode_chunked_sharded`` bit-equal to
  ``decode_chunked``.
* The JAX package's ``decode_chunked`` reads a sharded MAX_ERROR
  container within the bound (0.1, plus its decoder's ``DECODER_EPS_REL``
  of the range).  A sharded rate-mode container is within 1% of the size
  of the JAX package's ``encode_chunked`` on the same input (records may
  differ as ROADMAP Queue 3 allows); rate mode because the JAX package
  compiles its encode in ~3 s there and ~16 s in MAX_ERROR (``conftest``
  drops JAX's compiled programs after each test module, so no compile is
  shared between files).
* ``merge_container_parts`` of per-process ``encode_owned_chunks`` equals
  ``encode_chunked``; its header bytes equal the JAX package's.
* 2 and 4 processes in a gloo group (this file, run as a script, is the
  worker): each codes its own chunks and reduces a global range; the
  merged container is byte-identical to a one-process encode.
* ``dryrun_multidevice(2, device="cpu")`` runs.

Every port call passes ``device="cpu"``; the ``cuda``-marked tests run the
sharded encode and a one-rank NCCL ``all_reduce`` on the card.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import stream as tstream
from ebcc_tpu_torch.parallel import (dryrun_multidevice, make_mesh,
                                     multihost, sharded)
from ebcc_tpu_torch.parallel.mesh import batch_sharding

if __name__ != "__main__":
    # A gloo rank (this file run as a script) needs only the port.
    import ebcc_tpu
    from ebcc_tpu.core.kernels import DECODER_EPS_REL
    from ebcc_tpu.parallel import multihost as jmultihost

DIMS = (6, 64, 64)
CHUNK = (1, 64, 64)
ERROR = 0.1
QUANTILE = 1e-2
MODES = {
    "max_error": dict(residual_mode=et.RESIDUAL_MAX_ERROR, error=ERROR),
    "rate": dict(),
    "lossless": dict(residual_mode=et.RESIDUAL_LOSSLESS),
    "pointwise_nan": dict(
        residual_mode=et.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-3,
        allow_nan=True),
    "temporal": dict(residual_mode=et.RESIDUAL_MAX_ERROR, error=ERROR,
                     temporal=True),
}
WORKER_TIMEOUT_S = 120


def smooth_frames(dims=DIMS, seed=0):
    """Smooth fields with 16x16 blocks of coarse noise and fine noise (the
    residual layer ships on them at a 1e-2 base quantile)."""
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        f = 260 + 25 * np.sin(yy / h * np.pi + i) * np.cos(xx / w * 6.28)
        f += np.kron(rng.normal(size=(-(-h // 16), -(-w // 16))),
                     np.ones((16, 16)))[:h, :w]
        out.append(f + 0.02 * rng.normal(size=(h, w)))
    return np.stack(out).astype(np.float32)


def configs(mode="max_error", dims=DIMS, chunk_dims=CHUNK):
    """-> (port config, port options)."""
    return (et.CodecConfig(dims=dims, chunk_dims=chunk_dims, base_cr=30,
                           zstd_level=3, **MODES[mode]),
            et.EncodeOptions(base_error_quantile=QUANTILE))


def jax_config(cfg):
    return ebcc_tpu.CodecConfig(**dataclasses.asdict(cfg))


def mode_data(mode, n):
    x = smooth_frames((n, 64, 64), seed=n)
    if MODES[mode].get("allow_nan"):
        x[0, 10:40, 5:50] = np.nan
    return x


@pytest.fixture(scope="module")
def unsharded():
    """(mode, chunks) -> (data, port config, options, encode_chunked
    container, decode_chunked array)."""
    out = {}
    for mode, n in [(m, n) for m in ("max_error", "rate", "lossless")
                    for n in (5, 2)] + [("pointwise_nan", 5),
                                        ("temporal", 6)]:
        t = 3 if mode == "temporal" else 1
        x = mode_data(mode, n)
        cfg, opts = configs(mode, x.shape, (t, 64, 64))
        blob = et.encode_chunked(x, cfg, opts, device="cpu")
        out[mode, n] = (x, cfg, opts, blob,
                        et.decode_chunked(blob, device="cpu"))
    return out


@pytest.mark.parametrize("n, p", [(n, p) for n in (1, 2, 5, 6, 10, 32)
                                  for p in (1, 2, 3, 4, 7, 40)])
def test_host_chunk_slice_matches_jax(n, p):
    got = [multihost.host_chunk_slice(n, pid, p) for pid in range(p)]
    assert got == [jmultihost.host_chunk_slice(n, pid, p)
                   for pid in range(p)]
    assert [i for s, e in got for i in range(s, e)] == list(range(n))


@pytest.mark.parametrize("n, k", [(5, 1), (5, 2), (5, 3), (2, 3), (0, 2),
                                  (32, 6)])
def test_batch_sharding_is_contiguous_and_balanced(n, k):
    mesh = make_mesh(device="cpu", n=k)
    parts = batch_sharding(mesh, n)
    assert [d for d, _, _ in parts] == mesh.flat
    assert [i for _, s, e in parts for i in range(s, e)] == list(range(n))
    sizes = [e - s for _, s, e in parts]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_make_mesh(monkeypatch):
    mesh = make_mesh(device="cpu", n=4, shape=(2, 2))
    assert mesh.shape == (2, 2) and mesh.size == 4
    assert (mesh.rank, mesh.world_size) == (0, 1)
    assert mesh.axis_names == ("hosts", "chunks")
    assert make_mesh(device="cpu").flat == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(device="cpu", n=4, shape=(3, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


SHARDED_CASES = ([(m, n, k) for m in ("max_error", "rate", "lossless")
                  for n in (5, 2) for k in (1, 2, 3)]
                 + [("pointwise_nan", 5, 2), ("temporal", 6, 2)])


@pytest.mark.parametrize("mode, n, k", SHARDED_CASES)
def test_sharded_equals_encode_chunked(unsharded, mode, n, k):
    x, cfg, opts, blob, dec = unsharded[mode, n]
    mesh = make_mesh(device="cpu", n=k)
    got = sharded.encode_chunked_sharded(x, cfg, opts, mesh, max_batch=2)
    assert got == blob
    out = sharded.decode_chunked_sharded(blob, mesh, max_batch=2)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, dec)


def test_sharded_container_decodes_under_jax():
    """The JAX package's decoder reads a 3-device MAX_ERROR container within
    the bound (plus its decoder's ``DECODER_EPS_REL`` of the range)."""
    x = smooth_frames()
    cfg, opts = configs()
    blob = sharded.encode_chunked_sharded(x, cfg, opts,
                                          make_mesh(device="cpu", n=3))
    tol = ERROR + DECODER_EPS_REL * float(x.max() - x.min())
    assert np.abs(ebcc_tpu.decode_chunked(blob) - x).max() <= tol


def test_sharded_size_matches_jax():
    """A 3-device rate-mode container is within 1% of the JAX package's
    ``encode_chunked`` in size."""
    x = smooth_frames()
    cfg, opts = configs("rate")
    blob = sharded.encode_chunked_sharded(x, cfg, opts,
                                          make_mesh(device="cpu", n=3))
    jblob = ebcc_tpu.encode_chunked(
        x, jax_config(cfg),
        ebcc_tpu.EncodeOptions(base_error_quantile=QUANTILE))
    assert abs(len(blob) - len(jblob)) <= 0.01 * len(jblob)


def test_sharded_input_gate():
    """NaN without ``allow_nan`` raises as ``encode_chunked`` does; a plain
    ETPU stream decodes through ``decode``."""
    x = smooth_frames((2, 64, 64))
    cfg, opts = configs(dims=x.shape)
    mesh = make_mesh(device="cpu", n=2)
    bad = x.copy()
    bad[1, 3, 3] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        sharded.encode_chunked_sharded(bad, cfg, opts, mesh)
    one = dataclasses.replace(cfg, dims=(1, 64, 64), chunk_dims=(0, 0, 0))
    s = et.encode(x[:1], one, opts, device="cpu")
    np.testing.assert_array_equal(
        sharded.decode_chunked_sharded(s, mesh),
        et.decode(s, device="cpu"))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_global_range(k):
    x = smooth_frames((5, 64, 64))
    mesh = make_mesh(device="cpu", n=k)
    want = (float(x.min()), float(x.max()))
    assert sharded.global_range(x, mesh) == want
    assert sharded.global_range(torch.from_numpy(x), mesh) == want
    assert sharded.global_range(x[:0], mesh) == (np.inf, -np.inf)
    x[3, 2, 1] = np.nan
    assert np.isnan(sharded.global_range(x, mesh)).all()


@pytest.mark.parametrize("procs", [1, 3, 8])
def test_merged_parts_equal_encode_chunked(unsharded, procs):
    """Per-process runs merged under one header == ``encode_chunked``
    (8 processes own 5 chunks: the last ones own none); the header
    equals the JAX package's ``merge_container_parts``."""
    x, cfg, opts, blob, _ = unsharded["max_error", 5]
    parts = []
    for pid in range(procs):
        streams, (s, e) = multihost.encode_owned_chunks(
            x, cfg, opts, process_id=pid, process_count=procs, device="cpu")
        assert (s, e) == multihost.host_chunk_slice(5, pid, procs)
        parts.append(multihost.container_part(streams))
    merged = multihost.merge_container_parts(cfg, parts)
    assert merged == blob
    assert jmultihost.merge_container_parts(jax_config(cfg), []) == \
        merged[:tstream.CHUNKED_HEADER_SIZE]


def test_owned_chunks_without_a_group_are_all(unsharded):
    x, cfg, opts, blob, _ = unsharded["rate", 2]
    streams, span = multihost.encode_owned_chunks(x, cfg, opts, device="cpu")
    assert span == (0, 2)
    assert multihost.merge_container_parts(
        cfg, [multihost.container_part(streams)]) == blob


def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        multihost.initialize("localhost:1", device="cpu")


def test_dryrun_multidevice_cpu():
    out = dryrun_multidevice(2, device="cpu")
    assert out["intra"]["max_error"] <= 0.5
    assert out["temporal"]["max_error"] <= 0.5


@pytest.mark.parametrize("call", ["encode_chunked_sharded",
                                  "decode_chunked_sharded",
                                  "encode_owned_chunks", "dryrun"])
def test_default_device_is_the_card(unsharded, monkeypatch, call):
    x, cfg, opts, blob, _ = unsharded["max_error", 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "encode_chunked_sharded":
            sharded.encode_chunked_sharded(x, cfg, opts)
        elif call == "decode_chunked_sharded":
            sharded.decode_chunked_sharded(blob)
        elif call == "encode_owned_chunks":
            multihost.encode_owned_chunks(x, cfg, opts)
        else:
            dryrun_multidevice(1)


# ---------------------------------------------------------------------------
# Several processes in one gloo group
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(coord, nprocs, pid, outdir):
    """One rank: join the group, code the owned chunks, reduce the global
    range of the owned frames across ranks, write the records and a
    summary."""
    torch.set_num_threads(1)
    assert multihost.initialize(coord, nprocs, pid, backend="gloo",
                                device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.world_size) == (pid, nprocs)
        x = smooth_frames()
        cfg, opts = configs()
        streams, (s, e) = multihost.encode_owned_chunks(x, cfg, opts,
                                                        device="cpu")
        lo, hi = sharded.global_range(x[s:e], mesh)
        with open(os.path.join(outdir, f"part{pid}.bin"), "wb") as f:
            f.write(multihost.container_part(streams))
        with open(os.path.join(outdir, f"meta{pid}.json"), "w") as f:
            json.dump({"start": s, "stop": e, "lo": lo, "hi": hi}, f)
    finally:
        torch.distributed.destroy_process_group()


def _start_workers(nprocs, outdir):
    coord = f"localhost:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(nprocs),
         str(pid), str(outdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nprocs)]


GLOO_SIZES = (2, 4)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Both process groups run at once -> size -> (outdir, [(return code,
    output)] per rank).  Every worker has ``WORKER_TIMEOUT_S``; any left
    running is killed."""
    dirs = {n: tmp_path_factory.mktemp(f"gloo{n}") for n in GLOO_SIZES}
    procs = {n: _start_workers(n, dirs[n]) for n in GLOO_SIZES}
    results = {n: [] for n in GLOO_SIZES}
    try:
        for n in GLOO_SIZES:
            for p in procs[n]:
                try:
                    out = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\n(timed out)"
                results[n].append((p.returncode, out))
    finally:
        for p in (p for n in GLOO_SIZES for p in procs[n]):
            if p.poll() is None:
                p.kill()
                p.wait()
    return {n: (dirs[n], results[n]) for n in GLOO_SIZES}


@pytest.mark.parametrize("nprocs", GLOO_SIZES)
def test_gloo_processes_merge_to_one_container(gloo_runs, nprocs):
    outdir, results = gloo_runs[nprocs]
    for rc, out in results:
        assert rc == 0, f"worker failed:\n{out}"
    x = smooth_frames()
    cfg, opts = configs()
    metas = [json.loads((outdir / f"meta{p}.json").read_text())
             for p in range(nprocs)]
    assert [(m["start"], m["stop"]) for m in metas] == [
        multihost.host_chunk_slice(DIMS[0], p, nprocs)
        for p in range(nprocs)]
    for m in metas:
        assert (m["lo"], m["hi"]) == (float(x.min()), float(x.max()))
    parts = [(outdir / f"part{p}.bin").read_bytes() for p in range(nprocs)]
    assert multihost.merge_container_parts(cfg, parts) == \
        et.encode_chunked(x, cfg, opts, device="cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_sharded_equals_encode_chunked(card):
    x = smooth_frames((8, 721, 1440))
    cfg, opts = configs(dims=x.shape, chunk_dims=(1, 721, 1440))
    mesh = make_mesh()
    blob = et.encode_chunked(x, cfg, opts, max_batch=2)
    assert sharded.encode_chunked_sharded(x, cfg, opts, mesh,
                                          max_batch=2) == blob
    np.testing.assert_array_equal(
        sharded.decode_chunked_sharded(blob, mesh), et.decode_chunked(blob))
    assert sharded.global_range(x, mesh) == (float(x.min()), float(x.max()))


@pytest.mark.cuda
def test_card_nccl_all_reduce_one_rank(card):
    """One NCCL rank (NCCL refuses two on one card): ``all_reduce`` MIN and
    MAX of a CUDA tensor, and ``global_range`` through the group."""
    dist = torch.distributed
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    assert multihost.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        t = torch.tensor([3.0, -2.0], device=card)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        assert t.tolist() == [3.0, -2.0]
        x = smooth_frames((2, 64, 64))
        assert sharded.global_range(x, make_mesh()) == (
            float(x.min()), float(x.max()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
