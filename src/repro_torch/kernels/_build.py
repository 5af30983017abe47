"""Build and load the port's CUDA kernels with ``nvcc`` + ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --fmad=false -Xptxas -v -o lib<name>.so <name>.cu

into ``build/repro_torch_kernels/<hash>/`` at the repository root, where
``<hash>`` covers every source under ``csrc/`` and the flags, so a changed
source builds anew and an unchanged one loads at once. ``build_all`` starts
one ``nvcc`` per source, all together. Nothing of PyTorch's C++ extension
machinery is involved: the libraries link against the CUDA runtime only, and
the wrappers pass device pointers and the current stream as integers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")
_C_VOID_P = ctypes.c_void_p
# argtypes/restype of every exported C function, per library
_SIGNATURES = {
    "stacked_lookup": {
        "plex_stacked_lookup": ([_C_VOID_P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 _C_VOID_P], ctypes.c_int),
        "plex_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "plex_params_size": ([], ctypes.c_int),
    },
    "segment_lookup": {
        "plex_segment_lookup": ([_C_VOID_P, ctypes.c_int, ctypes.c_int,
                                 _C_VOID_P], ctypes.c_int),
        "segment_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "segment_params_size": ([], ctypes.c_int),
    },
    "bounded_search": {
        "plex_bounded_search": ([_C_VOID_P, ctypes.c_int, _C_VOID_P],
                                ctypes.c_int),
        "bounded_search_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "bounded_search_params_size": ([], ctypes.c_int),
    },
    "flash_attention": {
        "flash_attention_fwd": ([_C_VOID_P, _C_VOID_P], ctypes.c_int),
        "flash_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "flash_attention_params_size": ([], ctypes.c_int),
    },
    "flash_attention_sm90": {
        "flash_attention_sm90_fwd": ([_C_VOID_P, _C_VOID_P], ctypes.c_int),
        "flash_attention_sm90_error_string": ([ctypes.c_int],
                                              ctypes.c_char_p),
        "flash_attention_sm90_params_size": ([], ctypes.c_int),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_root() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the repository root (the checkout
    holding ``src/repro_torch``), else under the working directory."""
    pkg = CSRC.parents[1]                     # .../repro_torch
    base = (pkg.parents[1] if pkg.parent.name == "src"
            else pathlib.Path.cwd())
    return base / "build" / "repro_torch_kernels"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    return build_root() / source_hash() / f"lib{name}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns the library path per name; the
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``lib<name>.log``."""
    names = sorted(f.stem for f in CSRC.glob("*.cu"))
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    out_dir = next(iter(paths.values())).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"lib{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n} (rc {rc}): "
                          + (out_dir / f"lib{n}.log").read_text()[-4000:])
        else:
            os.replace(tmp, paths[n])       # atomic publish of the library
    if failed:
        raise RuntimeError("nvcc failed for " + "; ".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    every function's argtypes and restype set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn, (args, res) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = res
            _loaded[name] = lib
        return lib


def device_ptr(name: str, t, dtype, device) -> int:
    """Device pointer of a contiguous 1-D tensor a kernel reads or writes,
    after the checks the kernel cannot make itself."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the launch on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    return t.data_ptr()


def check_params_size(lib: ctypes.CDLL, fn: str, struct) -> None:
    """Refuse a launch whose ctypes parameter block does not match the C
    struct it mirrors (``fn`` returns the struct's size)."""
    if getattr(lib, fn)() != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} does not match its C struct "
                           f"({fn})")


def check_launch(lib: ctypes.CDLL, fn: str, err: int, what: str) -> None:
    """Raise with the CUDA error string when a launch returned an error
    (``fn`` is the library's error-string function)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({getattr(lib, fn)(err)!r})")
