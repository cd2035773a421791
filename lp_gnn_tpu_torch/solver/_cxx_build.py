"""Build the native simplex engine (``solver/native/*.cc``) with the C++
compiler, the counterpart of the JAX package's ``solver/native/Makefile``.

The same compiler (``$CXX``, ``g++`` where it is unset) and the same flags
as the Makefile, so that the two builds pivot alike on one machine. The
rules of ``ops/_build.py``, without torch (the prep stages' solver
processes load the library and import no torch): each target builds into
``lp_gnn_tpu_torch/_build/<target>-<hash>[.so]``, where the hash covers
its sources, the compiler, the flags and the CPU that ``-march=native``
targets, so an edited source builds anew and an unchanged one is reused.
A build writes a temporary file and renames it into place, so that
concurrent callers are safe; a failed build raises with the compiler's
output. Nothing is built when a module is imported.

    libtpulp   the shared library ``solver/native.py`` and
               ``ops/host_spmm.py`` load (``tpulp_solve``, ``tpulp_spmm``,
               ``tpulp_sddmm``)
    prof_main  the profiling driver over a ``dump_lp_bin`` file
"""
from __future__ import annotations

import hashlib
import os
import shlex
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native"]
# target -> (sources, flags after CXXFLAGS, file suffix), the Makefile's rules
TARGETS = {"libtpulp": (("tpulp.cc",), ["-shared"], ".so"),
           "prof_main": (("prof_main.cc", "tpulp.cc"), [], "")}


def _cxx() -> list[str]:
    return shlex.split(os.environ.get("CXX") or "g++")


def _host_cpu() -> bytes:
    """What ``-march=native`` resolves from: the first processor's model
    and flags in ``/proc/cpuinfo`` (empty where there is none)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            text = f.read()
    except OSError:
        return b""
    keep = [ln for ln in text.split(b"\n\n", 1)[0].splitlines()
            if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep)


def output_path(target: str = "libtpulp") -> Path:
    """The target's path, named by a hash of its sources, the compiler,
    the flags and the host CPU."""
    sources, extra, suffix = TARGETS[target]
    h = hashlib.sha256(" ".join(_cxx() + CXXFLAGS + extra).encode())
    for src in sources:
        h.update((SRC_DIR / src).read_bytes())
    h.update(_host_cpu())
    return BUILD_DIR / f"{target}-{h.hexdigest()[:16]}{suffix}"


def build(target: str = "libtpulp") -> Path:
    """Build the target unless it exists; returns its path. Raises
    RuntimeError with the compiler's output where the build fails."""
    out = output_path(target)
    if out.exists():
        return out
    sources, extra, suffix = TARGETS[target]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix or ".bin", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*_cxx(), *CXXFLAGS, *extra, "-o", tmp,
           *(str(SRC_DIR / s) for s in sources)]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:   # no such compiler
            raise RuntimeError(f"{shlex.join(cmd)} did not start: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{shlex.join(cmd)} failed (exit "
                               f"{res.returncode}):\n{res.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
