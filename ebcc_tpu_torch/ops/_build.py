"""Build and load the port's native libraries.

At first use each library is compiled into ``ebcc_tpu_torch/csrc/build/``
(listed in ``.gitignore``) and loaded with ``ctypes``:

* the CUDA kernels, ``csrc/<name>.cu`` -> ``lib<name>.so`` with ``nvcc``
  (:func:`load`);
* the host C++ of ``csrc/host/`` (:data:`HOST_LIBS`, :func:`load_host`)
  with ``c++`` and the reference's release flags: ``libebcc_host.so``
  (the CAB coders, the sparse packer/unpacker and the Rice coders of the
  exchange, no dependency) and
  ``libebcc_native_codec.so`` (the whole host codec, for native routing;
  links ``-lzstd``).

A library is rebuilt when any of its sources is newer.  Each build writes a
per-process temporary file and renames it into place, so concurrent
processes building at once each end with a whole library.  A failed build
raises ``RuntimeError`` with the compiler's output.  Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# The reference's release flags (ebcc_tpu/native/CMakeLists.txt): no FMA
# contraction, so the native decoder tracks the others at the ulp level.
CXX_FLAGS = ["-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC"]
# name -> (sources under csrc/host/ compiled, headers they include, libs).
HOST_LIBS = {
    "ebcc_host": (["cab_coder.cc", "sparse_unpack.cc", "rice_decode.cc",
                   "rice_block_pack.cc"], [], []),
    "ebcc_native_codec": (["etpu_codec.cc", "cab_coder.cc"],
                          ["etpu_codec.h"], ["-lzstd"]),
}

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}
_LIBS: dict = {}
BUILD_SECONDS: dict = {}


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


def _compile(name: str, srcs, deps, cmd_of) -> str:
    """``build/lib<name>.so`` from ``srcs`` (rebuilt when it is older than
    any of ``srcs`` + ``deps``); ``cmd_of(out)`` is the compiler command."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(p) for p in (*srcs, *deps)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(cmd_of(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building lib{name}.so failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` -> ``build/lib<name>.so`` if stale; returns
    the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    return _compile(name, [src], [],
                    lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src])


def build_host(name: str) -> str:
    """Compile the host library ``name`` of :data:`HOST_LIBS` if stale;
    returns the library path."""
    srcs, headers, libs = HOST_LIBS[name]
    srcs = [os.path.join(CSRC, "host", s) for s in srcs]
    deps = [os.path.join(CSRC, "host", s) for s in headers]
    return _compile(name, srcs, deps,
                    lambda tmp: [cxx_path(), *CXX_FLAGS, "-o", tmp, *srcs,
                                 *libs])


def _load(name: str, builder) -> ctypes.CDLL:
    # One lock per library: threads building different libraries compile
    # in parallel, threads asking for the same one wait for its build.
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
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
