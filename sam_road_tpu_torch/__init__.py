"""sam_road_tpu_torch: the PyTorch / CUDA port of sam_road_tpu.

Region inference (fused-encoder phase 1, host vertex extraction, TopoNet
phase 2) on one NVIDIA Hopper GPU, with the encoder's four TPU kernels
rewritten as hand-written CUDA kernels (csrc/, built at first use by
ops/_build.py). Module names mirror the JAX package's, so each module has
its counterpart there; the JAX package is the reference the tests hold this
one against. Importing this package imports neither jax nor sam_road_tpu,
and nothing heavy: submodules are imported where they are used.
"""

__version__ = "0.1.0"
