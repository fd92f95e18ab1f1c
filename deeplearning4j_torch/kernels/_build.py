"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; the Hopper
sources share ``csrc/sm90_common.cuh``. At first use a source is compiled
for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, where the hash
covers the source, every header it includes from ``csrc/`` and the
compiler flags, so an edited source or header rebuilds and an unchanged one
loads the library built before. A missing ``nvcc`` or a failed build
raises: there is no fallback. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as
``<lib>.log``.
:func:`build_all` compiles every source at once, one nvcc per source.
:func:`launch` calls a loaded launcher on PyTorch's current stream and
counts the launch on the kernel's wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("flash_fwd", "flash_fwd_sm90", "flash_bwd", "flash_bwd_sm90",
           "bn_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME or "
                       "/usr/local/cuda): the port's CUDA kernels cannot be "
                       "built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with ``#include
    "..."``, directly or through another header, each once, in the order
    first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is current; returns the
    library's path. Raises on a missing nvcc or a failed build."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    log = lib.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        with open(log, "w") as out:
            rc = subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT,
                                timeout=BUILD_TIMEOUT_S).returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name} (nvcc exit {rc}):\n"
                           + log.read_text()[-4000:])
    os.replace(tmp, lib)
    return lib


def build_all() -> List[Path]:
    """Compile every kernel in ``KERNELS`` that is not current, the nvcc
    processes running side by side; returns the libraries' paths in
    ``KERNELS`` order. Holds the one build lock throughout, so a concurrent
    :func:`load` waits rather than compiling the same source twice."""
    with _lock:
        with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
            futures = [pool.submit(build, name) for name in KERNELS]
        return [f.result() for f in futures]


def build_log(name: str) -> str:
    """The compiler's report from the build of ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, prototypes: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale. On first
    load each C function named in ``prototypes`` gets its ctypes signature,
    ``(argtypes, restype)``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in prototypes.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def _arg(a):
    if a is None:
        return None
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


def launch(lib: ctypes.CDLL, fn: str, args, what: str, wrapper) -> None:
    """Call C launcher ``fn`` of ``lib`` with ``args`` (tensors passed as
    their data pointers) and PyTorch's current stream on the first
    argument's device; raise on a CUDA error (the launch was refused and
    never ran), else add one to ``wrapper.launches``."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*[_arg(a) for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.dl4j_cuda_error_string(rc).decode()}")
    with _count_lock:
        wrapper.launches += 1
