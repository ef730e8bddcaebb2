"""Build and bind the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

The sources in ``csrc/`` include no PyTorch header, so each builds in
seconds. A kernel is built at its first use, for ``sm_90a``, into
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); the library's file name carries a hash of the source and
the flags, so an edited source is built anew. ``build_all`` starts one
``nvcc`` for each source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module, on hosts
that may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("recflash_sls", "dot_interaction", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags: flash attention's 18 template instances optimise in
# parallel, one thread a CPU, and it links the driver API for its TMA maps
# (cuTensorMapEncodeTiled)
EXTRA_FLAGS = {"flash_attention": ("--split-compile", "0", "-lcuda")}
# the ``dtype`` argument of every C launcher
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).is_file():
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every named source not yet built, one ``nvcc`` each, all at
    once. Returns ``{name: compiler output}`` for those compiled now (with
    ``-Xptxas -v``: registers, shared memory and spills of each kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        compiler = compiler or nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, lib)      # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name``, built, loaded
    and bound on first use: its argument types set (``c_void_p`` for every
    pointer and the stream) and an ``int`` (a ``cudaError_t``) result.
    Later calls return the bound function as it is."""
    fn = _bound.get((name, symbol))
    if fn is None:
        if name not in _loaded:
            build_all((name,))
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name, symbol] = fn
    return fn
