"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so``,
compiled by ``nvcc`` for ``sm_90a`` with a plain C interface (no PyTorch
headers, so a source builds in seconds). The hash covers every file in
``csrc`` and the flags, so an edited source builds anew at first use.
Several sources build at once, one ``nvcc`` each. A failed build raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"   # used when nvcc is not on PATH


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill counts) of the last build."""
    return library_path(name).with_suffix(".log").read_text()


def nvcc() -> str:
    path = shutil.which("nvcc") or TOOLKIT_NVCC
    if not os.access(path, os.X_OK):
        raise RuntimeError(f"nvcc not found (neither on PATH nor at {TOOLKIT_NVCC}); "
                           "the CUDA kernels cannot be built")
    return path


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc process each, all started together. Returns name -> library."""
    names = list(names) if names is not None else sources()
    todo = [n for n in names if not library_path(n).exists()]
    procs = []
    if todo:
        nvcc()                       # raise before touching the build directory
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(n, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((n, proc, tmp, out))
    failed = []
    for n, proc, tmp, out in procs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{text}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in names}


@lru_cache(None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build([name])[name]))
