"""Kernel-level tools of the port (counterparts of the repository's tools/):
experiment_fused_ln (the kernel A/B) and profile_windowed_block (the
windowed block's stage split)."""
