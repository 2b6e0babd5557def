"""Kernel-level tools of the port (counterparts of the repository's tools/):
experiment_fused_ln (the kernel A/B), profile_windowed_block (the windowed
block's stage split), and the tools that carry their own kernels:
experiment_group_window (T1 diag_attn), experiment_window_attn (T2, T3) and
experiment_relpos_kernel (T4 sel_attention)."""
