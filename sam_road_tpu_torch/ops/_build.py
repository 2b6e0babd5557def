"""Build, load and count the port's CUDA kernels (csrc/*.cu), and the
recompute backward of their differentiable wrappers.

All sources are compiled by nvcc into one shared library with a plain C
interface at first use, into the git-ignored build directory, under a name
keyed by a hash of the sources and flags (sam_road_tpu_torch/_native.py),
and loaded with ctypes. Every pointer and the stream cross as c_void_p;
every C entry point returns cudaGetLastError() after its launches, and
`check` raises on a nonzero code. Nothing here is imported or built until a
wrapper is called on a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil

from sam_road_tpu_torch._native import PKG_DIR, build_and_load

CSRC_DIR = os.path.join(PKG_DIR, "csrc")
SOURCES = ("gemm.cu", "window_attention.cu", "relpos_attention.cu", "flash_attention.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches by wrapper name: each wrapper adds one where it launches
# its kernel, and nowhere else. chip_smoke.py reads these to show that the
# main path ran through every kernel.
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "samroad_ln_dense": [_P] * 6 + [_I] * 3 + [_P],
    "samroad_proj_ln_mlp_residual": [_P] * 13 + [_I] * 3 + [_P],
    "samroad_ln_dense_padded": [_P] * 5 + [_I] * 7 + [_P],
    "samroad_proj_ln_mlp_residual_grid": [_P] * 13 + [_I] * 7 + [_P],
    "samroad_window_attention": [_P] * 5 + [_I] * 8 + [_P],
    "samroad_relpos_attention": [_P] * 6 + [_I] * 4 + [_P],
    "samroad_flash_attention": [_P] * 4 + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    dll = build_and_load("samroad_kernels", nvcc_path(), NVCC_FLAGS,
                         [os.path.join(CSRC_DIR, s) for s in SOURCES])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned CUDA tensor of
    `dtype` (and `shape`, where given): what the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def recompute_vjp(ctx, plain, g, *static):
    """The backward of a differentiable wrapper whose forward launched a
    kernel (K6): re-run `plain` (the kernel's plain PyTorch version) on
    detached copies of the saved inputs and return torch.autograd.grad of it
    against the cotangent g, as jax.vjp(ref, *residuals)(g) does in the JAX
    package's custom_vjp backwards. `static` are the non-tensor arguments
    after the tensors. Launches no custom kernel. Gradients come in each
    input's dtype; None for an input that is None or needs none."""
    import torch

    saved = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves, *static), wanted, g) if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


def on_cpu(t) -> bool:
    """True for a CPU tensor (take the plain version); False for CUDA
    (launch the kernel); raise for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
