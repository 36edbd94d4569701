"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides).  A library's file name carries a
hash of its source and the flags, so an edited source is rebuilt.
:func:`build_all` starts one ``nvcc`` per source at once; :func:`library`
builds (if needed) and loads one.  Every library exports
``repro_error_string``, bound here; each kernel module binds its own
entries through the ``bind`` it passes to :func:`library`.
:func:`count_launch` is the launch counter the wrappers share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
#: The sources, one library each.
SOURCES = ("fused_mlp.cu", "bitvector.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Per source, what its build did: ``seconds`` (None when the library was
#: already built), the library ``path`` and nvcc's ``log`` (``-Xptxas -v``:
#: registers, spills).
BUILD_INFO: Dict[str, dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR", "").strip()
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "nvcc"
        if root and cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    tag = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{src.stem}-{tag}.so"


def _compile(source: str) -> None:
    out = library_path(source)
    info = BUILD_INFO.setdefault(source, {"seconds": None, "path": None, "log": ""})
    info["path"] = str(out)
    if out.exists():
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    info["seconds"] = time.perf_counter() - t0
    info["log"] = proc.stdout + proc.stderr


def build_all(sources: Iterable[str] = SOURCES) -> None:
    """Compile every source not yet built, one ``nvcc`` each, all at once."""
    sources = tuple(sources)
    with _LOCK, ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for fut in [pool.submit(_compile, s) for s in sources]:
            fut.result()


def library(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (once per source hash) and load the library of ``source``;
    ``bind`` declares its entries' argument types once, at load."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        _compile(source)
        lib = ctypes.CDLL(BUILD_INFO[source]["path"])
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        bind(lib)
        _LIBS[source] = lib
        return lib


def raise_on(err: int, lib: ctypes.CDLL, what: str, hint: str = "") -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.repro_error_string(err).decode()}){hint}"
        )


def count_launch(call: Callable, *names: str) -> None:
    """Add one to each named counter attribute of the wrapper ``call``
    (``launches`` when none is named), under one lock: a cluster's build
    and collect pools launch kernels from several host threads at once,
    and ``call.launches += 1`` is a read and a write that two threads
    can interleave."""
    with _COUNT_LOCK:
        for name in names or ("launches",):
            setattr(call, name, getattr(call, name) + 1)
