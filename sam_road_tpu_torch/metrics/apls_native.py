"""The native C++ APLS scorer, native/apls.cc (counterpart of
sam_road_tpu/metrics/apls_native.py).

The reference invokes its Go scorer per tile via `go run`
(reference: cityscale_metrics/apls.bash:15); here the C++ executable is
built once, with the JAX package's flags, under its own hashed name in the
port's build directory (_native.build_executable). A missing g++, a failed
compile or a failed run raises RuntimeError: nothing falls back to the
Python scorer, which runs only when the caller asks for it (use_native=False,
the evaluation CLI's --no_native).
"""

from __future__ import annotations

import subprocess

from sam_road_tpu_torch._native import build_executable, native_source


def ensure_apls_binary() -> str:
    """Build (if needed) and return the executable's path."""
    return build_executable("samroad_apls", "g++", ["-O2", "-std=c++17", "-pthread"],
                            [native_source("apls.cc")])


def apls_score_files_native(gt_path: str, prop_path: str, out_path: str,
                            spacenet: bool = False):
    """Run the native scorer on two [nodes, edges] JSON files; it writes
    "apls_gt apls_prop mean" with 6 decimals to out_path. Returns the three
    as floats."""
    cmd = [ensure_apls_binary(), gt_path, prop_path, out_path]
    if spacenet:
        cmd.append("spacenet")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exit {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    with open(out_path) as f:
        parts = f.read().split()
    return float(parts[0]), float(parts[1]), float(parts[2])
