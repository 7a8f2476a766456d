"""Build and load the port's hand-written CUDA kernels.

Each ``gelly_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use with ``nvcc`` into ``gelly_torch/_build/lib<name>.so``
(a shared library that does not include PyTorch's headers, so a build takes
seconds), then loaded with ``ctypes``. Nothing here runs at import time.

A library is rebuilt when its source, or any shared header
``csrc/*.cuh``, is newer than it. Builds write to a
temporary name and ``os.replace`` it into place, so concurrent processes
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ctypes signature of each kernel library's C entry points.
_P = ctypes.c_void_p
SIGNATURES = {
    "sorted_window_gather": {
        "sorted_window_gather_launch": (
            [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P],
            ctypes.c_int,
        ),
        "sorted_window_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "wedge_count_matrix": {
        "wedge_count_matrix_launch": (
            [_P, _P, _P, _P, ctypes.c_int, _P], ctypes.c_int),
        "wedge_count_matrix_prepass": (
            [_P, _P, _P, ctypes.c_int, _P], ctypes.c_int),
        "wedge_count_matrix_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "spanner_gate": {
        "spanner_sparse_insert_edges": (
            [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int),
        "spanner_sparse_insert_edges_batched": (
            [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int),
        "spanner_gate_smem_bytes": (
            [ctypes.c_int] * 5, ctypes.c_int),
        "spanner_gate_smem_limit": ([], ctypes.c_int),
        "spanner_gate_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "hashset": {
        "hashset_insert_launch": (
            [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, _P, _P],
            ctypes.c_int),
        "hashset_contains_launch": (
            [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
        "hashset_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "row_insert": {
        "row_insert_launch": (
            [_P] * 6 + [ctypes.c_int] * 3 + [_P], ctypes.c_int),
        "row_insert_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "sampler_step": {
        "sampler_step_launch": (
            [_P] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
            ctypes.c_int),
        "sampler_step_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "matching_step": {
        "matching_step_launch": (
            [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
        "matching_step_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}


@dataclass
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (the -Xptxas -v register/shared-memory lines)


_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of gelly_torch are compiled at first use"
    )


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _fresh(name: str) -> bool:
    """Is the library newer than its source and every shared header?"""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return False
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return os.path.getmtime(lib) >= max(os.path.getmtime(d) for d in deps)


def build_all(names=None, force: bool = False) -> list[BuildResult]:
    """Compile the kernel libraries ``names`` (default: every source in
    ``csrc/``), one ``nvcc`` per source, all started together. Raises with
    the compiler's output if any build fails."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    results = []
    for name in names:
        src, lib = _paths(name)
        if not force and _fresh(name):
            results.append(BuildResult(name, lib, 0.0, ""))
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, lib, tmp, t0, p))
    failures = []
    for name, lib, tmp, t0, p in procs:
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {p.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        results.append(BuildResult(name, lib, secs, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if not _fresh(name):
        build_all([name])
    lib = ctypes.CDLL(_paths(name)[1])
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib
