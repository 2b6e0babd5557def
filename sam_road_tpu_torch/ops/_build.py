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
SOURCES = ("gemm.cu", "window_attention.cu", "relpos_attention.cu", "probes.cu",
           "folded_attention_f32.cu")
HEADERS = ("mma_bf16.cuh",)  # included by gemm.cu, the bf16 attention kernels and probes.cu
# --ptxas-options=-v: each instance's registers and spills, in the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

# Kernel launches by wrapper name: each wrapper adds one where it launches
# its kernel, and nowhere else. chip_smoke.py reads these to show that the
# main path ran through every kernel.
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "samroad_ln_dense": [_P] * 7 + [_I] * 3 + [_P],
    "samroad_proj_ln_mlp_residual": [_P] * 14 + [_I] * 3 + [_P],
    "samroad_ln_dense_padded": [_P] * 6 + [_I] * 7 + [_P],
    "samroad_proj_ln_mlp_residual_grid": [_P] * 14 + [_I] * 7 + [_P],
    "samroad_ln_mlp_residual": [_P] * 10 + [_I] * 3 + [_P],
    "samroad_window_attention": [_P] * 5 + [_I] * 8 + [_P],
    "samroad_window_attention_rows": [_P] * 4 + [_I] * 5 + [_P],
    "samroad_window_attention_relpos": [_P] * 4 + [_I] * 5 + [_P],
    "samroad_window_attention_relpos_batched": [_P] * 6 + [_I] * 5 + [_P],
    "samroad_relpos_attention": [_P] * 6 + [_I] * 5 + [_P],
    "samroad_folded_attention": [_P] * 4 + [_I] * 4 + [_P],
    "samroad_folded_attention_f32": [_P] * 4 + [_I] * 4 + [_P],
    "samroad_sel_attention": [_P] * 6 + [_I] * 3 + [_P],
    "samroad_window_attn_folded": [_P] * 4 + [_I] * 4 + [_P],
    "samroad_diag_attention": [_P] * 3 + [_I] * 5 + [_P],
    "samroad_relpos_attention_table": [_P] * 6 + [_I] * 5 + [_P],
    "samroad_merge_dense": [_P] * 3 + [_I] * 3 + [_P],
    "samroad_rowmax_dot": [_P] * 3 + [_I] * 7 + [_P],
    "samroad_row_block_affine": [_P] * 2 + [_I] * 4 + [_L] + [_F] * 2 + [_P],
    "samroad_window_colsum": [_P] * 2 + [_I] * 6 + [_P],
    "samroad_batched_nt": [_P] * 3 + [_I] * 4 + [_P],
    "samroad_batched_nt_grid": [_I] * 3 + [ctypes.POINTER(_I)],
}

# head dims the attention kernels are instantiated at (window_attention.cu,
# relpos_attention.cu): ViT-B and vit_l's 64, vit_h's 80
HEAD_DIMS = (64, 80)


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
                         [os.path.join(CSRC_DIR, s) for s in SOURCES],
                         [os.path.join(CSRC_DIR, h) for h in HEADERS])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_of(t) -> int:
    """The current stream of t's device. A kernel launches on the current
    device, so a tensor on another card raises (callers that drive several
    cards enter torch.cuda.device(...) per shard, parallel/mesh.py). Reads
    the device and the raw stream handle from torch._C, the calls under
    torch.cuda.current_device() / current_stream() (and what PyTorch's
    own compiled code reads its stream with), without the Stream object
    the public call builds: a few microseconds a launch."""
    import torch

    current = torch._C._cuda_getDevice()
    if t.get_device() != current:
        raise RuntimeError(f"tensor on {t.device} but the current device is cuda:{current}")
    return torch._C._cuda_getCurrentRawStream(current)


def require(t, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned CUDA tensor of
    `dtype` (and `shape`, where given): what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def gemm_block_n(N: int, K: int, name: str) -> int:
    """The N width of csrc/gemm.cu's block tile for a product with N output
    columns and depth K: 256 where N % 256 == 0, else 128; raise unless
    N % 128 == 0 and K % 64 == 0 (a K tile is 64 deep)."""
    if N <= 0 or K <= 0 or N % 128 or K % 64:
        raise ValueError(f"{name} kernel needs N % 128 == 0 and K % 64 == 0 (the GEMM's "
                         f"128- or 256-wide block tile and 64-deep K tiles), got N={N} K={K}")
    return 256 if N % 256 == 0 else 128


def require_head_dim(hd: int, name: str) -> None:
    """Raise unless the attention kernels have an instance at head_dim hd."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel has instances at head_dim {HEAD_DIMS}, got {hd}")


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
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")
