"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/<name>-<hash>.so`` beside the package, with a plain C
interface; the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
library. Builds happen at first use (or all at once,
in parallel, through :func:`build_all`), never at import. The build
directory is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers, spills and shared memory, kept in
# ``ptxas_log`` for the sources built in this process
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# every kernel source and the C functions it exports: name -> (restype,
# argtypes) per symbol
_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # {batch, length, head}
KERNELS: dict[str, dict[str, tuple]] = {
    "nf4_matmul": {
        "nf4_matmul_wgmma_launch": (_I, [_P] * 6 + [_I] * 4 + [_P]),
        "nf4_matmul_thin_launch": (_I, [_P] * 6 + [_I] * 4 + [_P]),
        "nf4_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "nf4_matmul_bwd": {
        "nf4_matmul_bwd_launch": (_I, [_P] * 6 + [_I] * 4 + [_P]),
        "nf4_bwd_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_fwd_launch": (
            _I, [_P] * 5 + [_I] * 5 + [_STRIDES] * 3 + [ctypes.c_float, _P]),
        "flash_bwd_dq_launch": (
            _I, [_P] * 7 + [_I] * 5 + [_STRIDES] * 4 + [ctypes.c_float, _P]),
        "flash_bwd_dkv_launch": (
            _I, [_P] * 8 + [_I] * 5 + [_STRIDES] * 4 + [ctypes.c_float, _P]),
        "flash_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "int4_matmul": {
        "int4_matmul_wgmma_launch": (_I, [_P] * 5 + [_I] * 6 + [_P]),
        "int4_matmul_bwd_launch": (_I, [_P] * 5 + [_I] * 6 + [_P]),
        "int4_matmul_thin_launch": (_I, [_P] * 5 + [_I] * 6 + [_P]),
        "int4_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "int8_matmul": {
        "int8_matmul_wgmma_launch": (_I, [_P] * 4 + [_I] * 4 + [_P]),
        "int8_matmul_thin_launch": (_I, [_P] * 4 + [_I] * 4 + [_P]),
        "int8_matmul_bwd_launch": (_I, [_P] * 5 + [_I] * 4 + [_P]),
        "int8_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}  # source name -> nvcc output of its build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path | None = None) -> list[str]:
    """The nvcc command line that builds kernel ``name``."""
    out = out if out is not None else library_path(name)
    return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(source_path(name))]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary output path, final path)."""
    final = library_path(name)
    if final.exists():
        return None, None, final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, proc, tmp: Path, final: Path) -> None:
    if proc is None:
        return
    output, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {source_path(name)} (exit {proc.returncode}):"
            f"\n{output}")
    os.replace(tmp, final)  # atomic: a concurrent builder sees all or none
    ptxas_log[name] = output


def build_all() -> float:
    """Build every kernel (one nvcc per source, all started together);
    returns the wall seconds spent."""
    t0 = time.monotonic()
    with _lock:
        started = [(n, *_start(n)) for n in KERNELS]
        for n, proc, tmp, final in started:
            _finish(n, proc, tmp, final)
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (a
    build's seconds go to every watching
    :class:`~llm_in_practise_tpu_torch.obs.prof.CompileMeter`)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        t0 = time.monotonic()
        proc, tmp, final = _start(name)
        _finish(name, proc, tmp, final)
        if proc is not None:
            from llm_in_practise_tpu_torch.obs.prof import note_build

            note_build(time.monotonic() - t0)
        lib = ctypes.CDLL(str(final))
        for sym, (restype, argtypes) in KERNELS[name].items():
            fn = getattr(lib, sym)
            fn.restype = restype
            fn.argtypes = argtypes
        _loaded[name] = lib
        return lib
