"""Kernel-level tools of the port (counterparts of the repository's tools/):
experiment_fused_ln (the kernel A/B), profile_windowed_block (the windowed
block's stage split), and the tools that carry their own kernels:
experiment_group_window (T1 diag_attn), experiment_window_attn (T2, T3),
experiment_relpos_kernel (T4 sel_attention), experiment_block_variants (T5
inker_attention, in whole windowed and global blocks), probe_mosaic (T6
merge_dense, T7 batched_dot, T8 lane_slice), probe_nondiv_blocks (T9-T12)
and repro_aot_crash (T13). The inference measurement tools, which carry no
kernel: bench (the repository's bench.py workload), profile_phase1,
profile_extract_p2, profile_phase2, abtest_engine, experiment_infer_batch,
profile_encoder and experiment_fused_encoder. The training measurement
tools, which carry no kernel either: profile_training_feed,
experiment_train_memory, sweep_train_throughput, experiment_fused_train,
profile_topo (host only) and verify_real_ckpt; _train.py and _fixtures.py
hold what they share."""
