"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` (plus the headers beside it) is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C interface
under `build/` at the repository root, at its first use, and loaded with
`ctypes`.  A library's file name carries a hash of the sources, the compile
defines and the flags, so an edited source is rebuilt and a stale library
is never loaded.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or under $CUDA_HOME/bin)")


def _lib_path(name: str, defines: dict) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(sorted(defines.items())).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _command(name: str, defines: dict, out: Path, verbose: bool) -> list[str]:
    cmd = [_nvcc()] + NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted(defines.items())]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def build(specs: list[tuple[str, dict]], verbose: bool = False) -> float:
    """Compile every (name, defines) spec whose library is missing, one nvcc
    per source, all started together.  Prints the compiler's resource usage
    (`-Xptxas -v`) when `verbose`.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in specs:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(_command(name, defines, Path(tmp), verbose),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        procs.append((name, defines, out, Path(tmp), proc))
    failed = []
    for name, defines, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name} {defines}]\n{log.rstrip()}", flush=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} {defines}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, defines: dict | None = None) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` built with `defines`."""
    defines = dict(defines or {})
    key = (name, tuple(sorted(defines.items())))
    if key not in _loaded:
        path = _lib_path(name, defines)
        if not path.exists():
            build([(name, defines)])
        lib = ctypes.CDLL(str(path))
        lib.fs_error_string.argtypes = [ctypes.c_int]
        lib.fs_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return _loaded[key]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError
    after the launch: a refused launch never runs and a later synchronize
    would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.fs_error_string(err).decode()})")
