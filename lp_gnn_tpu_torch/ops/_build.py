"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and builds on its own
into ``lp_gnn_tpu_torch/_build/lib<name>-<hash>.so``, where the hash covers
the source, the ``csrc/`` headers it includes and the compiler flags, so an
edited source or header builds anew and an unchanged one is reused. The
build happens at the first call of a kernel (or up front, all sources at
once, through :func:`build_all`); nothing is built when a module is
imported. A failed build raises: there is no
fallback to a kernel's plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# held while a library is built and loaded, and while a launch is counted
# (with one edge shard a device the shards' threads launch at once)
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of lp_gnn_tpu_torch need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers of
    ``csrc/`` that the source includes and the compiler flags."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    for inc in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', src, re.M):
        h.update((SRC_DIR / inc.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, temp output, final path, log path) or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    rc = proc.wait()
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n"
                           f"{log.read_text()}")
    os.replace(tmp, out)


def build_all(names) -> dict[str, str]:
    """Build every named kernel library at once, one nvcc each, all started
    together. Returns name -> compiler log (register / spill report)."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    logs = {}
    for n in names:
        log = lib_path(n).with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def count_launch(wrapper, n: int = 1) -> None:
    """``wrapper.launches += n``, under a lock, so that launches from
    several threads at once are all counted."""
    with _COUNT_LOCK:
        wrapper.launches += n


def check_out(out: torch.Tensor, shape: tuple, like: torch.Tensor,
              name: str) -> None:
    """Refuse an ``out=`` tensor a kernel cannot write: another shape, dtype
    or device than ``like`` gives, not contiguous, or (on the card) not
    16-byte aligned."""
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{name} out= must have shape {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    if out.dtype != like.dtype:
        raise TypeError(f"{name} out= must be {like.dtype}, got {out.dtype}")
    if out.device != like.device:
        raise ValueError(f"{name} out= on {out.device}, inputs on {like.device}")
    if not out.is_contiguous():
        raise ValueError(f"{name} out= must be contiguous")
    if out.device.type == "cuda" and out.data_ptr() % 16:
        raise ValueError(f"{name} out= must be 16-byte aligned on the card "
                         "(a view at a storage offset may not be)")


def launch_on(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``, a kernel's C launcher, on ``dev``'s current
    stream. ``dev`` is made current for the call only when it is not
    already, and the stream is read as a raw handle: entering
    ``torch.cuda.device`` and building a ``torch.cuda.Stream`` cost
    microseconds each, which add up on the narrow launches that are bound
    by the host."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


# Each kernel's workspaces, one set per kernel, device and stream (launches
# that share one must be ordered): zeroed when allocated, grown when the
# kernel asks for more, and handed back by every launch zeroed where it
# counts. Each entry holds the tensors and their (pointer, bytes) pairs.
_WORKSPACE: dict[tuple[str, int, int], tuple[list, tuple]] = {}
# Keys whose current workspaces a CUDA graph has captured, and the
# workspaces such a key outgrew: a captured graph keeps the pointers it was
# captured with, so they are never freed.
_CAPTURED: set = set()
_OUTGROWN: list = []


def launch_with_workspace(name: str, dev: torch.device, fn, *args,
                          buffers: int = 1) -> int:
    """``fn(*args, ws_1, bytes_1, ..., ws_k, bytes_k, stream)`` on ``dev``'s
    current stream (as :func:`launch_on`) for a launcher that takes its
    caller's ``buffers`` workspaces last and returns -n, without launching,
    when one of them holds fewer than n KiB: every one is then made n KiB
    of zeros and the launch made again. A kernel whose launches differ in
    grid keeps its arrival counts in a workspace of their own, so that one
    launch's scratch never lands where another's counts are.

    Under CUDA graph capture nothing is allocated: the same work run once
    on the capture stream beforehand must have made the workspaces (a
    capture that finds them too small raises). Workspaces a graph captured
    stay allocated when their key grows."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_with_workspace(name, dev, fn, *args, buffers=buffers)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (name, dev.index, stream)
    ws = _WORKSPACE.get(key)
    rc = fn(*args, *(ws[1] if ws else (0, 0) * buffers), stream)
    if rc < 0:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{name}: its workspace on this stream is missing or too "
                "small, and none is allocated during a CUDA graph capture: "
                "run the same work once on the capture stream first")
        if key in _CAPTURED:
            _OUTGROWN.append(ws[0])
            _CAPTURED.discard(key)
        tensors = [torch.zeros(-rc * 1024, dtype=torch.uint8, device=dev)
                   for _ in range(buffers)]
        sizes = tuple(v for t in tensors for v in (t.data_ptr(), t.numel()))
        _WORKSPACE[key] = (tensors, sizes)
        rc = fn(*args, *sizes, stream)
    if key not in _CAPTURED and torch.cuda.is_current_stream_capturing():
        _CAPTURED.add(key)
    return rc
