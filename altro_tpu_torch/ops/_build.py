"""Build the port's CUDA kernels from the sources in the checkout.

No JAX counterpart: the JAX package lowered its Pallas kernels at trace
time. Here `load()` compiles every `csrc/*.cu` of the package with nvcc,
one process per source, all started together, and links the objects
into one shared library with a plain C interface, on first use, then
loads it with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libaltro_kernels.so *.o

The library lands in `altro_tpu_torch/_build/<hash>/`, keyed by a hash of
the sources (`*.cu` and the shared headers `*.cuh`) and the commands, so
an edited source or header rebuilds and an unchanged tree loads at once.
A file lock keeps two processes from building at the same time. A failed build raises with nvcc's output;
nothing falls back. `check_operand` / `check_operands` are the wrappers'
shared check of what every kernel takes (contiguous float32 CUDA tensors
of the stated shape).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libaltro_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points of csrc/*.cu and their argument types. Every pointer and
# the stream are c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "rollout_grid_f32": [_P] * 19 + [_P] * 2 + [_I] * 8 + [_P] + [_P],
    "riccati_latency_f32": [_P] * 9 + [_P] * 7 + [_I] * 5 + [_P],
    "trial_rollout_f32": [_P] * 16 + [_P] * 2 + [_I] * 3 + [_I] * 2 + [_P] + [_P],
    "riccati_dense_f32": [_P] * 9 + [_P] * 7 + [_I] * 5 + [_P],
}

_lib = None


def sources() -> list:
    """Every kernel source and shared header of csrc/, sorted."""
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def compile_command(obj_path: str, src: str) -> list:
    """The nvcc command line that compiles one kernel source."""
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            "-Xptxas=-v", "-c", "-o", obj_path, src]


def link_command(out_path: str, objs) -> list:
    """The nvcc command line that links the objects into the library."""
    return [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", out_path, *objs]


def _key(srcs) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(compile_command("obj", "src")[1:]).encode())
    h.update(" ".join(link_command("lib", ["obj"])[1:]).encode())
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
            cus = [s for s in srcs if s.endswith(".cu")]
            objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + ".o") for s in cus]
            procs = [subprocess.Popen(compile_command(o, s), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for o, s in zip(objs, cus)]
            logs = []
            for src, proc in zip(cus, procs):
                out, err = proc.communicate()
                logs.append(f"Compiling {os.path.basename(src)}\n{err}")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                       f"(exit {proc.returncode}):\n{out}\n{err}")
            tmp = lib_path + f".tmp{os.getpid()}"
            proc = subprocess.run(link_command(tmp, objs), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
            log = "\n".join(logs + [proc.stderr])
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(log)
            return lib_path, log
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


def check_operand(kernel: str, name: str, t, shape) -> None:
    """Raise unless operand `name` of `kernel` is a contiguous float32 CUDA
    tensor of the given shape (what every kernel of csrc/ takes). One
    expression when the operand is fine: the wrappers run it per operand
    on every launch."""
    if (t.dtype is torch.float32 and t.is_cuda and t.shape == shape
            and t.is_contiguous()):
        return
    if t.dtype != torch.float32:
        raise TypeError(f"{kernel} kernel: {name} must be float32, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{kernel} kernel: {name} is not on a CUDA device")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel} kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} must be contiguous")


def check_operands(kernel: str, ops) -> None:
    """`check_operand` over ops, a sequence of (name, tensor, shape): one
    expression when every operand is fine, the first fault's raise when
    not."""
    if all(t.dtype is torch.float32 and t.is_cuda and t.shape == shape and t.is_contiguous()
           for _, t, shape in ops):
        return
    for name, t, shape in ops:
        check_operand(kernel, name, t, shape)


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
