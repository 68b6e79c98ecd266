"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` source compiles on its own, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface, loaded with
``ctypes``.  All sources build in parallel (one ``nvcc`` each) at the first
kernel call, into ``build/repro_torch_kernels/`` of the checkout (next to
the package for an installed copy).  A library's file name carries a hash
of its source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is reused.  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = (_PKG.parents[1] / "build" / "repro_torch_kernels"
             if _PKG.parent.name == "src" else _PKG / "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
# each launcher: (library, exported C symbol, its argument types); every one
# returns cudaError_t
SIGNATURES: dict[str, tuple[str, str, list]] = {
    "expand_filter": ("expand_filter", "repro_expand_filter_compact",
                      [P, I, P, I, I, P, P, P, I, P, P, I, P, P, P, P, I, P]),
    "edge_exists": ("edge_exists", "repro_edge_exists",
                    [P, P, P, P, P, I, I, I, P]),
    "tile_membership": ("tile_membership", "repro_tile_membership",
                        [P, P, P, I, I, I, P]),
    "tile_membership_range": ("tile_membership",
                              "repro_tile_membership_range",
                              [P, I, P, I, P, L, P, I, I, P, P]),
    "bitmap_superset": ("bitmap_superset", "repro_bitmap_superset",
                        [P, P, P, P, I, I, I, I, P]),
    "signature_filter": ("signature_filter", "repro_signature_filter",
                         [P, P, P, P, I, I, I, I, P]),
    "delta_merge": ("delta_merge", "repro_delta_merge",
                    [P, I, P, I, P, I, P, P, P, P, P, P, I, P, P, P, P, I, I,
                     P]),
    "segment_gather": ("segment_gather", "repro_segment_gather",
                       [P, I, I, I, P, P, I, I, P, P]),
    "segment_gather_sum": ("segment_gather", "repro_segment_gather_sum",
                           [P, I, I, I, I, P, P, P, P, I, P, P]),
}
LIBRARIES = sorted({lib for lib, _, _ in SIGNATURES.values()})

_lock = threading.Lock()
_funcs: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the repro_torch CUDA kernels "
                           "build from source at first use")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    headers = sorted(CSRC.glob("*.cuh"))
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 *(p.read_bytes() for p in headers),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, all ``nvcc``
    processes at once; returns ``{name: library path}``.  The compiler's
    register/spill report of each build is kept beside its library as
    ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in LIBRARIES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


def kernel(name: str):
    """The ctypes launcher ``name`` of ``SIGNATURES`` (every library built
    and loaded at the first call)."""
    fn = _funcs.get(name)
    if fn is not None:
        return fn
    with _lock:
        if not _funcs:
            libs = {lib: ctypes.CDLL(str(path))
                    for lib, path in build_all().items()}
            for entry, (lib, symbol, argtypes) in SIGNATURES.items():
                f = getattr(libs[lib], symbol)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _funcs[entry] = f
    return _funcs[name]
