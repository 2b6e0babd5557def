"""Build-and-load for the port's shared libraries and executables.

Host C++ (the repository's native/*.cc, shared with the JAX package) is
compiled with g++, and the CUDA kernels (csrc/) with nvcc (ops/_build.py).
native/apls.cc is an executable (build_executable), the rest are shared
libraries. Each is built at first use into BUILD_DIR,
which .gitignore lists, under a file name keyed by a hash of its sources and
flags, so an edited source or flag is rebuilt and never mixed up with a stale
build. A failed build raises: there is no fallback path.
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
    ctypes.CDLL; a library that does not load raises RuntimeError."""
    exe, lib = _target(name, compiler, flags, list(sources) + list(headers), "lib{}-{}.so")
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
        _install(tmp, lib, log)
    try:
        return ctypes.CDLL(lib)
    except OSError as e:
        raise RuntimeError(f"loading {lib} failed: {e}") from e


def build_executable(name: str, compiler: str, flags: list, sources: list) -> str:
    """Compile and link `sources` in one compiler call into the executable
    BUILD_DIR/<name>-<hash>, keyed and installed as build_and_load's
    libraries are (a temporary file renamed into place, the compiler's
    output in the path + ".log"). Returns its path."""
    exe, binary = _target(name, compiler, flags, sources, "{}-{}")
    if not os.path.exists(binary):
        tmp = f"{binary}.{os.getpid()}.tmp"
        try:
            log = _run([[exe] + flags + ["-o", tmp] + list(sources)], name, compiler)
        except RuntimeError:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        _install(tmp, binary, log)
    return binary


def _target(name: str, compiler: str, flags: list, files: list, pattern: str):
    """The compiler's path and the build's file in BUILD_DIR: `pattern`
    formatted with the name and a hash of the compiler, the flags and the
    files' contents. Raises when the compiler is missing."""
    exe = shutil.which(compiler)
    if exe is None:
        raise RuntimeError(f"{compiler} not found: cannot build {name}")
    h = hashlib.sha256(" ".join([compiler] + flags).encode())
    for src in files:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return exe, os.path.join(BUILD_DIR, pattern.format(name, h.hexdigest()[:16]))


def _install(tmp: str, path: str, log: str) -> None:
    os.replace(tmp, path)
    with open(f"{path}.log", "w") as f:
        f.write(log)


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
