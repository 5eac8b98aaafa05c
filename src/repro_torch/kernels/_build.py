"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, at first use, then loaded with ``ctypes``. The library's
file name carries a hash of the source, of every ``csrc`` header it
includes (``#include "x.cuh"``, followed through headers) and of the flags,
so an edited source or header is rebuilt and an unchanged one is loaded as
it is. Nothing here runs at
import: the CPU tests import every module, and ``nvcc`` is only called when
a kernel is first launched (or ``build_all`` is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: nvcc flags: Hopper's arch-specific target, IEEE math (no --use_fast_math),
#: a shared library with a C interface, and ptxas's register/spill report.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name → {"path", "seconds", "cached", "ptxas"} of each library built or
#: found in this process.
BUILD_LOG: dict = {}

_LIBS: dict = {}


def _nvcc() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through other headers, in the order first reached."""
    seen = [CSRC / f"{name}.cu"]
    for path in seen:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists() and dep not in seen:
                seen.append(dep)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the pending
    (process, temporary output, t0) or None."""
    out = _target(name)
    if out.exists():
        # a library this process built keeps its entry (and ptxas report)
        if BUILD_LOG.get(name, {}).get("path") != str(out):
            BUILD_LOG[name] = {"path": str(out), "seconds": 0.0,
                               "cached": True, "ptxas": ""}
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, pending) -> None:
    proc, tmp, t0 = pending
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{stdout}{stderr}")
    out = _target(name)
    os.replace(tmp, out)
    ptxas = "\n".join(line for line in (stdout + stderr).splitlines()
                      if re.search(r"ptxas info|spill|registers", line))
    BUILD_LOG[name] = {"path": str(out), "seconds": time.perf_counter() - t0,
                       "cached": False, "ptxas": ptxas}


def ptxas_entries(ptxas: str) -> dict:
    """A ``BUILD_LOG`` entry's ptxas report split by kernel: each mangled
    entry name → its report lines (stack, spills, registers, shared
    memory), in the order ptxas printed them."""
    out: dict = {}
    lines = None
    for line in ptxas.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            lines = out.setdefault(entry.group(1), [])
        elif lines is not None and "Function properties" not in line:
            lines.append(line.split(":", 1)[-1].strip()
                         if "ptxas info" in line else line.strip())
    return out


def build_all() -> dict:
    """Build every source under ``csrc/`` that has no library yet, one nvcc
    per source, all started together. Returns ``BUILD_LOG``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    pending = {n: _start(n) for n in names}
    for n, pend in pending.items():
        if pend is not None:
            _finish(n, pend)
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        pend = _start(name)
        if pend is not None:
            _finish(name, pend)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


__all__ = ["BUILD_DIR", "BUILD_LOG", "NVCC_FLAGS", "build_all", "load",
           "ptxas_entries"]
