"""Build and load the native (C) hot path of the FLAC decoder.

Compiles `csrc/flac_native.c` with the system C compiler at its first use
into the repository's `build/` (the directory the CUDA kernels build into,
`kernels/_build.py`), under a name that carries a hash of the source, and
loads it with ctypes.  A single translation unit with a flat C ABI, no
pybind11.  Nothing here runs when the module is imported.  Where no
compiler works, `load()` returns None and `data/flac.py` decodes with its
pure-Python path, which is also the parity oracle
(tests/test_torch_port_data.py pins native == python).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from fseend_tpu_torch.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "flac_native.c"
_loaded: dict = {}


def lib_path() -> Path:
    """Where the library of the current source lives."""
    return BUILD_DIR / f"libflac_native_{hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(SRC), "-o", tmp],
                               capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            r = None
        if r is not None and r.returncode == 0:
            os.replace(tmp, out)    # atomic: a concurrent loader never sees half a file
            return True
        os.unlink(tmp)
    return False


def load() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; None without a working
    C compiler."""
    if "lib" not in _loaded:
        out = lib_path()
        lib = None
        if out.exists() or _compile(out):
            lib = ctypes.CDLL(str(out))
            LL, I, U8P, I64P, I32P = (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int32))
            lib.flac_rice_residual.restype = LL
            lib.flac_rice_residual.argtypes = [U8P, LL, LL, LL, I, I, I64P]
            lib.flac_read_verbatim.restype = LL
            lib.flac_read_verbatim.argtypes = [U8P, LL, LL, LL, I, I64P]
            lib.flac_fixed_restore.restype = None
            lib.flac_fixed_restore.argtypes = [I64P, LL, I]
            lib.flac_lpc_restore.restype = None
            lib.flac_lpc_restore.argtypes = [I64P, LL, I, I32P, I]
        _loaded["lib"] = lib
    return _loaded["lib"]


def _u8(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def rice_residual(bits, n: int, predictor_order: int, param_bits: int) -> np.ndarray:
    """Native drop-in for flac.py::_rice_residual (advances bits.pos)."""
    out = np.empty(n - predictor_order, np.int64)
    new_pos = load().flac_rice_residual(_u8(bits.data), len(bits.data) * 8, bits.pos, n,
                                        predictor_order, param_bits, _i64(out))
    if new_pos < 0:
        raise IndexError("FLAC bitstream overrun in residual")
    bits.pos = int(new_pos)
    return out


def read_verbatim(bits, n: int, depth: int) -> np.ndarray:
    out = np.empty(n, np.int64)
    new_pos = load().flac_read_verbatim(_u8(bits.data), len(bits.data) * 8, bits.pos, n,
                                        depth, _i64(out))
    if new_pos < 0:
        raise IndexError("FLAC bitstream overrun in verbatim subframe")
    bits.pos = int(new_pos)
    return out


def fixed_restore(out: np.ndarray, order: int) -> None:
    load().flac_fixed_restore(_i64(out), len(out), order)


def lpc_restore(out: np.ndarray, order: int, coefs, shift: int) -> None:
    c = np.asarray(coefs, np.int32)
    load().flac_lpc_restore(_i64(out), len(out), order,
                            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), shift)
