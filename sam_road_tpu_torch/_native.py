"""Build-and-load for the port's shared libraries.

Host C++ (the repository's native/nms.cc and native/pairs.cc, shared with
the JAX package) is compiled with g++, and the CUDA kernels (csrc/) with
nvcc (ops/_build.py). Each library is built at first use into BUILD_DIR,
which .gitignore lists, under a file name keyed by a hash of its sources and
flags, so an edited source or flag is rebuilt and never mixed up with a stale
library. A failed build raises: there is no fallback path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")


def build_and_load(name: str, compiler: str, flags: list, sources: list, headers=()):
    """Compile `sources` into BUILD_DIR/lib<name>-<hash>.so and load it.
    `headers` (included by the sources) count in the hash but are not
    compiled on their own.

    The sources compile at once, one compiler process each, into objects
    that one more call links. The compiler writes a temporary file
    that is renamed into place, so processes that build the same library at
    once never load a half-written one; what the compilers printed goes to
    the library's path + ".log" (for the CUDA kernels, ptxas's registers,
    spills and shared memory of every kernel instance). Returns the
    ctypes.CDLL."""
    exe = shutil.which(compiler)
    if exe is None:
        raise RuntimeError(f"{compiler} not found: cannot build {name}")
    h = hashlib.sha256(" ".join([compiler] + flags).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        compile_flags = [f for f in flags if f != "-shared"] + ["-c"]
        try:
            log = _run([[exe] + compile_flags + ["-o", o, s] for o, s in zip(objs, sources)],
                       name, compiler)
            log += _run([[exe] + flags + ["-o", tmp] + objs], name, compiler)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        os.replace(tmp, lib)
        with open(f"{lib}.log", "w") as f:
            f.write(log)
    return ctypes.CDLL(lib)


def _run(commands: list, name: str, compiler: str) -> str:
    """Run the commands all at once (one compiler process each) and raise
    if any failed, after all have ended; returns what they printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in commands]
    failed, log = [], ""
    for c, proc in zip(commands, procs):
        out, err = proc.communicate()
        log += f"$ {c[-1]}\n{out}{err}"
        if proc.returncode != 0:
            failed.append(f"{compiler} exit {proc.returncode}:\n{out}\n{err}")
    if failed:
        raise RuntimeError(f"building {name} failed ({'; '.join(failed)})")
    return log


def native_source(name: str) -> str:
    """Path of a C++ source in the repository's shared native/ folder."""
    src = os.path.join(REPO_DIR, "native", name)
    if not os.path.exists(src):
        raise FileNotFoundError(f"native source missing: {src}")
    return src
