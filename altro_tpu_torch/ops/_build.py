"""Build the port's CUDA kernels from the sources in the checkout.

No JAX counterpart: the JAX package lowered its Pallas kernels at trace
time. Here `load()` compiles every `csrc/*.cu` of the package with nvcc
into one shared library with a plain C interface, on first use, and
loads it with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o libaltro_kernels.so csrc/*.cu

The library lands in `altro_tpu_torch/_build/<hash>/`, keyed by a hash of
the sources and the command, so an edited source rebuilds and an
unchanged one loads at once. A file lock keeps two processes from
building at the same time. A failed build raises with nvcc's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libaltro_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points of csrc/*.cu and their argument types. Every pointer and
# the stream are c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "riccati_backward_diag_f32": [_P] * 7 + [_P] * 7 + [_I] * 4 + [_P],
    "rollout_grid_f32": [_P] * 16 + [_P] * 2 + [_I] * 6 + [_I, _F, _F] + [_P],
}

_lib = None


def sources() -> list:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(out_path: str, srcs=None) -> list:
    """The nvcc command line that builds the kernel library."""
    srcs = sources() if srcs is None else srcs
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", out_path, *srcs]


def _key(srcs) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(nvcc_command("lib", ["src"])[1:]).encode())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the library if its hash directory lacks it.

    Returns (library path, compiler log: nvcc's stderr, empty when the
    library was already built)."""
    srcs = sources()
    out_dir = os.path.join(BUILD_DIR, _key(srcs))
    lib_path = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib_path):
                return lib_path, ""
            tmp = lib_path + f".tmp{os.getpid()}"
            proc = subprocess.run(nvcc_command(tmp, srcs), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(proc.stderr)
            return lib_path, proc.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
