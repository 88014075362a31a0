"""Build and load the port's CUDA kernels.

Every ``pydynet_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``), all sources at once in parallel processes, and the
objects are linked into one shared library with a plain C interface, which
``ctypes`` loads. The library lives in ``build/pydynet_tpu_torch/`` at the
root of the source checkout (two levels above this package, so the port is
run from a checkout, not an installed copy), named by a hash of the sources
and flags, and is built at first use, so a fresh checkout builds everything
on its first call. A build that fails raises; nothing falls back to another
implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pydynet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (restype, argtypes) of every C entry point in csrc/
SIGNATURES = {
    "pdt_decode_token": (_I, [_I] * 3 + [_P] * 30 + [_I] * 7
                         + [ctypes.c_float, _P]),
    "pdt_decode_token_scratch_floats": (_I, [_I] * 5),
    "pdt_lm_head_argmax": (_I, [_I, _I] + [_P] * 5 + [_I] * 2 + [_P]),
    "pdt_lm_head_argmax_scratch_floats": (_I, [_I]),
    "pdt_decode_step": (_I, [_I] + [_P] * 20 + [_I] * 5
                        + [ctypes.c_float, _P]),
    "pdt_decode_step_scratch_floats": (_I, [_I] * 4),
    "pdt_decode_token_batched": (_I, [_I] * 4 + [_P] * 33 + [_I] * 8
                                 + [ctypes.c_float, _P]),
    "pdt_decode_token_batched_scratch_floats": (_I, [_I] * 6),
    "pdt_flash_fwd": (_I, [_I] + [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]),
    "pdt_flash_bwd_dq": (_I, [_I] + [_P] * 7 + [_I] * 4
                         + [ctypes.c_float, _P]),
    "pdt_flash_bwd_dkv": (_I, [_I] + [_P] * 8 + [_I] * 4
                          + [ctypes.c_float, _P]),
    "pdt_quantize_rows": (_I, [_I] + [_P] * 3 + [_I] * 2 + [_P]),
    "pdt_qmm_decode": (_I, [_I] * 2 + [_P] * 5 + [_I] * 2 + [_P]
                       + [_I] * 9 + [_P]),
    "pdt_qmm": (_I, [_I] + [_P] * 5 + [_I] * 2 + [_P] + [_I] * 3 + [_P]),
    "pdt_batch_norm_train": (_I, [_I, _I] + [_P] * 6 + [_I, _I]
                             + [ctypes.c_float, _P]),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source and need the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags is (or
    will be)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpdt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists. Returns its
    path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, jobs = [], []
        for src in sources():  # one nvcc a source, all started together
            objs.append(f"{tmp}/{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for cmd, proc in jobs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                errors.append(f"({proc.returncode}) {' '.join(cmd)}\n"
                              f"{output}")
        if not errors:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}/lib.so",
                   *objs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode == 0:
                os.replace(f"{tmp}/lib.so", out)
                return out
            errors.append(f"({proc.returncode}) {' '.join(cmd)}\n"
                          f"{proc.stdout}")
    raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C types."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
