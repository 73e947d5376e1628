"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one CUDA C++ source under ``src/repro_torch/csrc/`` with a
plain C interface (no PyTorch headers), compiled by ``nvcc`` for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <src>

into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of the source and
of every header under ``csrc/`` it includes (``mma_bf16.cuh``), so an
edited kernel or header is rebuilt and a built one is reused.  A failing
``nvcc`` raises with its stderr.  Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.
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
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("gossip_gather", "pme_average", "flash_attention", "ssd_intra_chunk")

_LIBS: Dict[str, ctypes.CDLL] = {}
# what the last build of each kernel printed (ptxas register / spill report)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> List[Path]:
    """`src` and the headers beside it that it includes, directly or through
    another header (system headers in <> are not followed)."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / h for h in _INCLUDE.findall(f.read_text())
                 if (f.parent / h).is_file()]
    return seen


def _target(name: str, csrc: Path = CSRC) -> Path:
    digest = hashlib.sha256()
    for f in _sources(csrc / f"{name}.cu"):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code (0 = launched)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
