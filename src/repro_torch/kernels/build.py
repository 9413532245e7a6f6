"""Build the QSQ CUDA kernels and load them with ctypes.

``load()`` compiles ``csrc/*.cu`` for ``sm_90a`` at first use into
``build/kernels/libqsq-<hash>.so`` under the repository root (one ``nvcc``
per source, all started together, then one link), and returns the loaded
library with every entry point's ``argtypes`` set.  The hash covers the
sources, the shared header and the flags, so an edited kernel is rebuilt
and a stale library is never loaded.  Nothing is built when the module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("qsq_matvec.cu", "qsq_matmul.cu", "qsq_quantize.cu")
HEADERS = ("qsq_common.cuh", "qsq_mma.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers and the stream as c_void_p, ints as c_int
SIGNATURES = {
    "qsq_matvec": [_P, _P, _P, _P] + [_I] * 13 + [_P],
    "qsq_matmul": [_P, _P, _P, _P] + [_I] * 13 + [_P],
    "qsq_matvec_masked": [_P, _P, _P, _P, _P] + [_I] * 13 + [_P],
    "qsq_matmul_masked": [_P, _P, _P, _P, _P] + [_I] * 13 + [_P],
    "qsq_quantize": [_P, _P, _P] + [_I] * 5 + [_P],
}

_lib: ctypes.CDLL | None = None
build_log: str = ""  # the compiler's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libqsq-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, objs, failed = [], [], []
        for src, obj, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src}\n{log}")
            objs.append(str(obj))
            if p.returncode:
                failed.append(src)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
