"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, and is loaded with ``ctypes``.  A library's file name
carries a hash of its source and flags, so a stale build is never loaded.
Building happens at first use (``load``), never at import, so the package
imports on machines without ``nvcc``; ``build_all`` starts one ``nvcc`` per
source, all together, and waits for them.  ``launch`` calls an entry point
on the current CUDA stream and raises if the launch was refused; ``layout``
asks a source for a size.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(names: List[str] | None = None) -> Dict[str, pathlib.Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have
    no current library, one ``nvcc`` process each, all started together.
    Returns name → library path; raises with nvcc's output on failure."""
    srcs = [CSRC / f"{n}.cu" for n in names] if names else \
        sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in srcs:
        target = _target(src)
        out[src.stem] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, target, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, target)      # atomic: readers never see a half
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            path = build_all([name])[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def layout(lib: str, name: str, *args: int) -> int:
    """Size query ``name`` of ``csrc/<lib>.cu`` (int arguments, a long long
    result), so that a kernel's layout of shared memory or scratch lives
    in its source alone."""
    f = getattr(load(lib), name)
    if f.argtypes is None:
        f.argtypes = [ctypes.c_int] * len(args)
        f.restype = ctypes.c_longlong
    return int(f(*args))


def launch(lib: str, name: str, argtypes: Sequence, *args) -> None:
    """Call entry point ``name`` of ``csrc/<lib>.cu`` with ``args`` (typed
    by ``argtypes``) and the current CUDA stream; raise if it returns a
    CUDA error."""
    import torch
    f = getattr(load(lib), name)
    if f.argtypes is None:
        f.argtypes = list(argtypes) + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
