"""The CAB coder's profile-guided build (``ops/_build.py``), on the CPU.

* The PGO and the plain ``libebcc_host.so`` are two files, and
  ``EBCC_NO_PGO=1`` selects the plain one; their CAB coders (backends 2
  and 4) write the same bytes and read them back.
* The PGO sequence itself, on a stand-in coder and trainer in a build
  directory of the test's own: a trained object is used, and a trainer
  that leaves no profile fails the sequence loudly, so the library falls
  back to the plain build and says so in ``BUILD_KIND``, and the failure
  is remembered.
"""

import ctypes
import os

import numpy as np
import pytest

from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.ops import _build


def _payload(rng, kept, d0, hp, wp, density):
    """A plane payload (``kept`` magnitude rows, then the sign row) whose
    signs sit only where some magnitude bit is set, as the packer writes
    them."""
    plane = d0 * hp * wp
    mags = (rng.random((kept, plane)) < density) & (
        rng.random((kept, plane)) < np.linspace(0.2, 1, kept)[:, None])
    signs = (rng.random(plane) < 0.5) & mags.any(0)
    return np.packbits(np.vstack([mags, signs[None]]), axis=1).tobytes()


@pytest.fixture(scope="module")
def builds():
    """"pgo" / "plain" -> libebcc_host.so of that build, bound."""
    out = {}
    for kind, pgo in (("pgo", True), ("plain", False)):
        path = _build.build_host("ebcc_host", pgo=pgo)
        assert _build.BUILD_KIND["ebcc_host"] == kind
        out[kind] = tnative.bind_host(ctypes.CDLL(path))
    return out


def test_no_pgo_selects_the_plain_file(monkeypatch):
    pgo = _build.build_host("ebcc_host")
    assert pgo == os.path.join(_build.BUILD_DIR, "libebcc_host.so")
    assert _build.BUILD_KIND["ebcc_host"] == "pgo"
    monkeypatch.setenv("EBCC_NO_PGO", "1")
    plain = _build.build_host("ebcc_host")
    assert plain == os.path.join(_build.BUILD_DIR, "nopgo", "libebcc_host.so")
    assert _build.BUILD_KIND["ebcc_host"] == "plain"


@pytest.mark.parametrize("coder", ["cab", "cab2"])
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_pgo_and_plain_write_the_same_bytes(builds, monkeypatch, coder,
                                            density):
    rng = np.random.default_rng(int(density * 100))
    geom = (5, 2, 64, 96, 3)                 # kept, d0, hp, wp, levels
    raw = _payload(rng, *geom[:4], density)
    comp = {}
    for kind, lib in builds.items():
        monkeypatch.setattr(tnative, "_host_lib", lib)
        comp[kind] = getattr(tnative, f"{coder}_compress")(raw, *geom)
        assert getattr(tnative, f"{coder}_decompress")(comp[kind],
                                                       *geom) == raw
    assert comp["pgo"] == comp["plain"]


_CODER = r"""
extern "C" int etpu_probe(int x) { return x * 3 + 1; }
"""
_TRAINER = r"""
#include <cstdlib>
#include <unistd.h>
extern "C" int etpu_probe(int);
int main() {
  int s = 0;
  for (int i = 0; i < 1000; ++i) s += etpu_probe(i);
  %s
}
"""


@pytest.mark.parametrize("profile", ["written", "missing"])
def test_pgo_sequence(tmp_path, monkeypatch, profile):
    """A trainer that exits through ``_exit`` writes no profile: the
    ``-fprofile-use`` compile must fail (``-Werror=missing-profile``) and
    the library fall back to the plain build, recorded in ``BUILD_KIND``;
    a trainer that exits normally gives the PGO build."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "cab_coder.cc").write_text(_CODER)
    (src / "cab_train.cc").write_text(
        _TRAINER % ("return s == 0;" if profile == "written" else "_exit(0);"))
    monkeypatch.setattr(_build, "HOST_SRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(_build.HOST_LIBS, "probe", (["cab_coder.cc"], [], []))
    monkeypatch.setattr(_build, "BUILD_KIND", {})
    path = _build.build_host("probe")
    lib = ctypes.CDLL(path)
    assert lib.etpu_probe(2) == 7
    if profile == "written":
        assert _build.BUILD_KIND["probe"] == "pgo"
        assert path == str(tmp_path / "build" / "libprobe.so")
        assert os.path.exists(tmp_path / "build" / "cab_coder.pgo.o")
    else:
        assert _build.BUILD_KIND["probe"].startswith("plain: the PGO")
        assert "missing-profile" in _build.BUILD_KIND["probe"]
        assert path == str(tmp_path / "build" / "nopgo" / "libprobe.so")
        assert not os.path.exists(tmp_path / "build" / "cab_coder.pgo.o")
        # The failure is remembered: the next build does not run the
        # sequence again.
        monkeypatch.setattr(_build, "BUILD_SECONDS", {})
        monkeypatch.setattr(_build, "BUILD_KIND", {})
        assert _build.build_host("probe") == path
        assert "missing-profile" in _build.BUILD_KIND["probe"]
        assert _build.BUILD_SECONDS == {}
    # The per-process profile directory is gone either way.
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.startswith("pgo.")]
