"""Build and load the port's host-side native libraries.

Own copy of ``rafiki_tpu/native/build.py``: each ``src/<name>.cpp`` is
compiled by ``g++`` into a shared library with a plain ``extern "C"``
interface, bound with ``ctypes``, at first use. Two differences:

- A missing compiler or a failed build raises :class:`NativeBuildError`
  with the compiler's output. The original returned None and its callers
  fell back to the in-process broker; here the native library is only
  asked for by an explicit setting (``RAFIKI_BROKER=shm``,
  ``RAFIKI_PLACEMENT=process``), which must not be ignored quietly.
- Libraries go to ``build/rafiki_tpu_torch/native/`` at the root of the
  checkout (not ``~/.cache``), named by a hash of the source, and are
  written to a temporary file then renamed into place, so several
  processes loading at once each see a whole library or none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "rafiki_tpu_torch" / "native")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """A native library could not be built (no ``g++``, or the compiler
    failed); the message carries the compiler's output."""


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``src/<name>.cpp`` unless its library exists; its path."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            f"g++ not found on PATH ({os.environ.get('PATH', '')!r}): cannot "
            f"build the native {name} library")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp),
         "-lpthread", "-lrt"],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed on {name}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``src/<name>.cpp``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_library(name)))
        return lib
