"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``; no PyTorch headers are involved,
so a build takes seconds. Libraries go to ``densepose_tpu_torch/_build/<key>``
where ``<key>`` hashes the sources and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is compiled at import time:
``library(name)`` builds on first use and raises if ``nvcc`` is missing or the
build fails.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no multiply
and add is contracted into an FMA (the kernels must round as the plain
PyTorch versions do). ``-Xptxas -v`` keeps each kernel's register, shared
memory and spill report in ``<name>.log`` beside its library.
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
from typing import Dict, Iterable, List, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = {"nms": "nms.cu", "roi_align": "roi_align.cu",
           "roi_align_sparse": "roi_align_sparse.cu", "conv_s8": "conv_s8.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: Path
    log: str          # nvcc and ptxas output of the build
    seconds: float    # wall time of this build; 0.0 when reused


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _out_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Built]:
    """Compile the named kernels, one nvcc process per source, all started
    together. Reuses libraries already built from the same sources."""
    out_dir = _out_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    built: Dict[str, Built] = {}
    running = {}
    for name in names:
        lib = out_dir / f"libdp_{name}.so"
        log = out_dir / f"{name}.log"
        if lib.exists():
            built[name] = Built(lib, log.read_text() if log.exists() else "", 0.0)
            continue
        tmp = out_dir / f"libdp_{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, tmp, lib, log, time.perf_counter())
    for name, (proc, tmp, lib, log, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{text}")
        log.write_text(text)
        os.replace(tmp, lib)
        built[name] = Built(lib, text, seconds)
    return built


# mangled template type arguments -> their names
_MANGLED_TYPES = {"f": "float", "6__half": "__half", "13__nv_bfloat16": "__nv_bfloat16"}


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier of a mangled name, read component by
    component of its nested name (length-prefixed, so the digits of an
    anonymous namespace's hash do not cut it), with its template arguments,
    if any: element types and integers."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            return mangled
        start = pos + m.end()
        pos = start + int(m.group())
        if mangled[start:pos].endswith("_kernel"):
            t = re.match(r"I((?:f|6__half|13__nv_bfloat16|Li\d+E)+)E", mangled[pos:])
            args = [_MANGLED_TYPES.get(a) or a[2:-1] for a in
                    re.findall(r"f|6__half|13__nv_bfloat16|Li\d+E", t.group(1))] if t else []
            return mangled[start:pos] + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str) -> List[dict]:
    """Per kernel of a build log: registers, static shared memory, stack
    frame and spills, from ptxas -v. A kernel is named by the ``*_kernel``
    part of its mangled name and its template arguments, if any: an element
    type and an integer (``roi_align_kernel<__half, 2>``)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name].path))
    return _LIBS[name]
