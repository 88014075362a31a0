"""Lazy g++ build and ctypes loader for the native components.

``lib<name>_<hash>.so`` is built from ``<name>.cpp`` into
``build/pydynet_tpu_torch/`` at the root of the checkout (the kernels'
directory, ``ops/_build.py``), the hash over the source and the flags, so
an edited source builds anew and an unchanged one is reused. A build writes
a unique temporary file and renames it, so two processes building at once
do not interleave. Where g++ is missing or fails, :func:`load_library`
returns None and the caller takes its Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pydynet_tpu_torch"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_CACHE = {}


def source_path(name: str) -> Path:
    return HERE / f"{name}.cpp"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _compile(name: str, lib: Path) -> bool:
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=lib.parent)
        os.close(fd)
    except OSError:
        return False
    cmd = ["g++", *FLAGS, str(source_path(name)), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_library(name: str):
    """Compile ``<name>.cpp`` once and load it; None when unavailable."""
    if name in _CACHE:
        return _CACHE[name]
    lib_file = library_path(name)
    lib = None
    if lib_file.exists() or _compile(name, lib_file):
        try:
            lib = ctypes.CDLL(str(lib_file))
        except OSError:
            lib = None
    _CACHE[name] = lib
    return lib


def native_available(name: str = "tokenizer") -> bool:
    return load_library(name) is not None
