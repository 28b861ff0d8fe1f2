"""Build the port's hand-written CUDA kernels at first use.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode=arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, which is loaded with ``ctypes``.  No PyTorch header is
compiled, so a build takes seconds rather than minutes.  The library
links the CUDA runtime as a shared library (``-cudart=shared``), so it
binds to the ``libcudart`` that PyTorch has already loaded and shares
its error state and current device.  The libraries go into ``ray_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the
source, of every ``csrc/*.cuh`` header it includes (``#include "..."``,
followed through headers), and of the flags, so an edited source or
header is rebuilt.  The bf16 kernels encode their TMA tensor maps with
``cuTensorMapEncodeTiled`` from ``libcuda``, so the libraries link
``-lcuda`` (the toolkit's stub at build time, the installed
``libcuda.so.1`` at run time).  A build that fails raises
``RuntimeError`` with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-cudart=shared", *ARCH_FLAGS]
LINK_FLAGS = ["-lcuda"]
# One library per source; the ctypes signature of each exported symbol.
SIGNATURES: Dict[str, Dict[str, Tuple[list, object]]] = {
    "flash_fwd": {
        "rtt_flash_fwd": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p],
            ctypes.c_int),
        "rtt_flash_fwd_route": ([ctypes.c_int], ctypes.c_char_p),
        "rtt_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "flash_bwd": {
        "rtt_flash_dq": (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p],
            ctypes.c_int),
        "rtt_flash_dkv": (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p],
            ctypes.c_int),
        "rtt_flash_dq_route": ([ctypes.c_int], ctypes.c_char_p),
        "rtt_flash_dkv_route": ([ctypes.c_int], ctypes.c_char_p),
        "rtt_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

# One lock a source, so that different sources build at the same time.
_locks = {name: threading.Lock() for name in SIGNATURES}
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc of the CUDA toolkit: $CUDA_HOME, then /usr/local/cuda,
    then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from source at first use")
    return found


def included_headers(name: str, csrc: Path = CSRC) -> list:
    """The ``csrc`` headers that ``csrc/<name>.cu`` includes with quotes,
    directly or through other headers, sorted by name."""
    seen, todo = set(), [csrc / f"{name}.cu"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = csrc / inc
            if path.exists() and path not in seen:
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<name>.cu``, the headers it includes and the nvcc
    flags: the build's cache key."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in included_headers(name, csrc):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return digest.hexdigest()


def build_command(name: str, out: Path) -> list:
    """The nvcc command line that builds ``csrc/<name>.cu`` into ``out``."""
    compiler = nvcc()
    stubs = Path(compiler).parent.parent / "lib64" / "stubs"
    link = ([f"-L{stubs}"] if stubs.is_dir() else []) + LINK_FLAGS
    return [compiler, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu"),
            *link]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _locks[name]:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = BUILD_DIR / f"lib{name}-{source_digest(name)[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(build_command(name, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit "
                                   f"{proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all
        lib = ctypes.CDLL(str(out))
        for sym, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
        return lib
