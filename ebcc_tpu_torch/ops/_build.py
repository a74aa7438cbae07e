"""Build and load the port's native libraries.

At first use each library is compiled into ``ebcc_tpu_torch/csrc/build/``
(listed in ``.gitignore``) and loaded with ``ctypes``:

* the CUDA kernels, ``csrc/<name>.cu`` -> ``lib<name>.so`` with ``nvcc``
  (:func:`load`);
* the host C++ of ``csrc/host/`` (:data:`HOST_LIBS`, :func:`load_host`)
  with ``c++`` and the reference's release flags: ``libebcc_host.so``
  (the CAB coders, the sparse packer/unpacker, the Rice coders of the
  exchange and the legacy SPIHT coder; no dependency),
  ``libebcc_native_codec.so`` (the whole host codec, for native routing)
  and the HDF5 filter plugin ``h5plugin/libebcc_h5filter.so`` (in a
  directory of its own: HDF5 opens every library of a plugin directory).
  The last two link ``libzstd.so.1``; ``csrc/host/zstd_decls.h`` declares
  what they call, so no ``zstd.h`` is needed.

Every host library links the CAB coder, and by default takes it with
profile-guided optimization, as the JAX package's CMake build does
(``ebcc_tpu/native/__init__.py`` ``build()``): :func:`cab_profiled_object`
compiles ``cab_coder.cc`` with ``-fprofile-generate``, runs the trainer
``cab_train.cc`` and compiles it again with ``-fprofile-use`` into one
object that every library links.  ``EBCC_NO_PGO=1`` builds the plain
libraries instead; they are other files (under ``build/nopgo/``), so
neither build is taken for the other.  A failed PGO sequence (a compiler
without ``libgcov``, say) falls back to the plain library, as in the JAX
package, and :data:`BUILD_KIND` records which build each library got; the
failure is remembered (``build/cab_coder.pgo.failed``) until the sources
or the compiler change.

A library is rebuilt when any of its sources is newer.  One process builds
a library at a time (``flock`` on a file in the build directory) and the
others then find it built; each build writes a per-process temporary file
and renames it into place, so a reader never sees half a library.  A failed build
raises ``RuntimeError`` with the compiler's output.  Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

from ..utils.logging import logger

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
HOST_SRC = os.path.join(CSRC, "host")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# The reference's release flags (ebcc_tpu/native/CMakeLists.txt): no FMA
# contraction, so the native decoder tracks the others at the ulp level.
CXX_FLAGS = ["-std=c++17", "-O3", "-ffp-contract=off", "-fPIC"]
_ZSTD = ["-l:libzstd.so.1"]     # the runtime library; no libzstd.so needed
_CODEC = ["etpu_codec.cc", "cab_coder.cc"]
# name -> (sources under csrc/host/ compiled, headers they include, libs).
# The CAB coder (cab_coder.cc) is in every one of them.
HOST_LIBS = {
    "ebcc_host": (["cab_coder.cc", "sparse_unpack.cc", "rice_decode.cc",
                   "rice_block_pack.cc", "spiht_coder.cc"], [], []),
    "ebcc_native_codec": (_CODEC, ["etpu_codec.h", "zstd_decls.h"], _ZSTD),
    # The JAX package's CMake target h5z_etpu: the plugin and every source.
    "ebcc_h5filter": (["h5z_etpu.cc", *_CODEC, "sparse_unpack.cc",
                       "rice_decode.cc", "rice_block_pack.cc",
                       "spiht_coder.cc"],
                      ["etpu_codec.h", "zstd_decls.h", "h5_minimal.h"],
                      _ZSTD),
}
PLUGIN = "ebcc_h5filter"
PGO_SOURCE, PGO_TRAINER = "cab_coder.cc", "cab_train.cc"

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}
_LIBS: dict = {}
# Seconds of each build this process ran: a kernel or host library by its
# name (a plain host library as "<name> (plain)"), the PGO sequence's
# steps as "cab_pgo_generate", "cab_pgo_train", "cab_pgo_use".
BUILD_SECONDS: dict = {}
# host library -> "pgo", "plain", or "plain: <why the PGO sequence failed>",
# for every host library this process built or found built.
BUILD_KIND: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def cxx_path() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++, g++ or $CXX) found: the host "
                       "libraries cannot be built")


def _lock(name: str) -> threading.Lock:
    """One lock per build product: threads building different products
    compile in parallel, threads asking for the same one wait for it."""
    with _LOCK:
        return _NAME_LOCKS.setdefault(name, threading.Lock())


@contextlib.contextmanager
def _building(key: str):
    """Held while the build product ``key`` is checked and built: by the
    threads of this process through a lock, by other processes (test
    workers that start at once) through ``flock`` on a file in the build
    directory, released when the file closes, also by a process that dies.
    So one process builds, and the others then find the product fresh."""
    with _lock(f"build {key}"):
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f".{key.replace(' ', '_')}.lock")
        with open(path, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            yield


def _run(cmd, what: str, **kw) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{proc.stdout}\n{proc.stderr}")


def _fresh(out: str, deps) -> bool:
    return os.path.exists(out) and os.path.getmtime(out) >= max(
        os.path.getmtime(p) for p in deps)


def _compile(key: str, out: str, deps, cmd_of) -> str:
    """``out`` unless it is older than any of ``deps``; else ``cmd_of(tmp)``
    is the compiler command that writes it (timed as ``key``)."""
    if _fresh(out, deps):
        return out
    with _building(key):
        if _fresh(out, deps):
            return out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        # The temporary file stays outside the plugin directory, where HDF5
        # would open it.
        tmp = os.path.join(BUILD_DIR, f"{key.replace(' ', '_')}."
                           f"{os.getpid()}.tmp")
        t0 = time.perf_counter()
        _run(cmd_of(tmp), f"building {os.path.relpath(out, BUILD_DIR)}")
        os.replace(tmp, out)
        BUILD_SECONDS[key] = time.perf_counter() - t0
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` -> ``build/lib<name>.so`` if stale; returns
    the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    return _compile(name, os.path.join(BUILD_DIR, f"lib{name}.so"), [src],
                    lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src])


def cab_profiled_object() -> str:
    """``build/cab_coder.pgo.o``: the CAB coder compiled with the profile of
    its trainer, rebuilt when either source is newer.  As the JAX CMake's
    ``cab_obj``, the coder is compiled once to an object, so the profile
    belongs to that very object: GCC names the profile after the object's
    path, and ``-Werror=missing-profile`` fails the last compile when the
    profile is not there (with ``-Wno-missing-profile`` it would build
    without it and say nothing).  The profile is made in a directory of
    this process's own, since concurrent processes build at once."""
    src, trainer = (os.path.join(HOST_SRC, f)
                    for f in (PGO_SOURCE, PGO_TRAINER))
    out = os.path.join(BUILD_DIR, "cab_coder.pgo.o")
    failed = os.path.join(BUILD_DIR, "cab_coder.pgo.failed")
    if _fresh(out, [src, trainer]):
        return out
    with _building("cab_pgo"):
        if _fresh(out, [src, trainer]):
            return out
        cxx = cxx_path()
        if _fresh(failed, [src, trainer]):
            with open(failed) as f:
                who, _, why = f.read().partition("\n")
            if who == cxx:
                raise RuntimeError(why)
        work = os.path.join(BUILD_DIR, f"pgo.{os.getpid()}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        obj, exe = os.path.join(work, "cab_coder.o"), os.path.join(
            work, "cab_train")
        steps = (
            ("generate", [cxx, *CXX_FLAGS, "-fprofile-generate", "-c", src,
                          "-o", obj]),
            ("generate", [cxx, *CXX_FLAGS, "-fprofile-generate", trainer,
                          obj, "-o", exe]),
            ("train", [exe]),
            ("use", [cxx, *CXX_FLAGS, "-fprofile-use",
                     "-fprofile-correction", "-Werror=missing-profile",
                     "-c", src, "-o", obj]))
        try:
            for step, cmd in steps:
                t0 = time.perf_counter()
                _run(cmd, f"the CAB PGO step {step}", cwd=work, timeout=300)
                key = f"cab_pgo_{step}"
                BUILD_SECONDS[key] = (BUILD_SECONDS.get(key, 0.0)
                                      + time.perf_counter() - t0)
            os.replace(obj, out)
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            # Remembered until the sources or the compiler change, so each
            # process does not pay for the sequence again.
            tmp = f"{failed}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(f"{cxx}\n{e}")
            os.replace(tmp, failed)
            raise
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return out


def build_host(name: str, pgo=None) -> str:
    """Compile the host library ``name`` of :data:`HOST_LIBS` if stale, with
    the CAB coder's PGO object unless ``pgo`` is false (by default: unless
    ``EBCC_NO_PGO`` is set); returns the library path."""
    srcs, headers, libs = HOST_LIBS[name]
    srcs = [os.path.join(HOST_SRC, s) for s in srcs]
    deps = srcs + [os.path.join(HOST_SRC, s) for s in headers]
    kind = "plain"
    if not os.environ.get("EBCC_NO_PGO") if pgo is None else pgo:
        try:
            obj = cab_profiled_object()
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
            why = [ln for ln in lines if "error" in ln or "cannot" in ln]
            kind = (f"plain: the PGO sequence failed with {cxx_path()}: "
                    f"{' '.join(why or lines[-3:])[:400]}")
            logger.warning("lib%s: %s", name, kind)
        else:
            kind = "pgo"
            srcs = [obj if s.endswith(PGO_SOURCE) else s for s in srcs]
            deps.append(obj)
    # The plain build under nopgo/, the plugin in a directory of its own.
    out = os.path.join(BUILD_DIR, *([] if kind == "pgo" else ["nopgo"]),
                       *(["h5plugin"] if name == PLUGIN else []),
                       f"lib{name}.so")
    out = _compile(name if kind == "pgo" else f"{name} (plain)", out, deps,
                   lambda tmp: [cxx_path(), *CXX_FLAGS, "-shared", "-o", tmp,
                                *srcs, *libs])
    BUILD_KIND[name] = kind
    return out


def _load(name: str, builder) -> ctypes.CDLL:
    with _lock(name):
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(builder(name))
            _LIBS[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so`` once per process."""
    return _load(name, build)


def load_host(name: str) -> ctypes.CDLL:
    """Build if needed, then load the host library ``name`` once per
    process."""
    return _load(name, build_host)
