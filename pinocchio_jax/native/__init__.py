"""Native (C) runtime components, compiled on demand.

The hot sequential piece of the pipeline — the fragmentation sweep — is C
(like the reference's build_groups.c); everything batch-parallel lives in
JAX/XLA.  Each shared library is built with the system compiler on first
use into build/native/ at the repository root (listed in .gitignore).  Its
file name carries a hash of the source, the compiler flags and the host
CPU, so a library built for another machine (the flags include
-march=native) is never loaded: a changed source or CPU builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_LOCK = threading.Lock()
_LIBS = {}

_CFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c11",
           "-fno-math-errno"]


def host_cpu() -> str:
    """Identity of the host CPU that -march=native compiles for: the model
    name and feature flags of /proc/cpuinfo where it exists."""
    try:
        with open("/proc/cpuinfo") as fd:
            keep = [ln.strip() for ln in fd
                    if ln.startswith(("model name", "flags", "Features",
                                      "CPU part"))]
        if keep:
            # one processor's lines suffice: the cores of a host match
            return "\n".join(dict.fromkeys(keep))
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_key(source: bytes, flags=_CFLAGS, cpu: str = None) -> str:
    """Hash naming one build of a source for one CPU and flag set."""
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    h.update((host_cpu() if cpu is None else cpu).encode())
    return h.hexdigest()[:16]


def _build(name: str) -> str:
    src = os.path.join(_HERE, name + ".c")
    with open(src, "rb") as fd:
        key = library_key(fd.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{key}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: concurrent processes
        # (test workers) never load a half-written library
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["cc"] + _CFLAGS + ["-o", tmp, src, "-lm"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"failed to build {name}: {res.stderr}\n{' '.join(cmd)}")
        os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name))
        return _LIBS[name]
