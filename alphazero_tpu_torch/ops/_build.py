"""Build the CUDA sources of ``ops/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``alphazero_tpu_torch/_build/lib<name>-<hash>.so`` (a
directory git ignores).  The hash covers the source and the flags, so an
edited source rebuilds and an unchanged one loads the library it built
before.  ``build_all`` starts one ``nvcc`` per source, all at once.

This is not ``torch.utils.cpp_extension.load``: sources that include
PyTorch's headers take minutes to compile, these take seconds."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built at first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all) that is not built yet, one
    ``nvcc`` process per source, in parallel.  Returns the library paths."""
    names = sources() if names is None else names
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, t)
        errors = []
        for n, (proc, tmp, t) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}")
            else:
                os.replace(tmp, t)
        if errors:
            raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LOADED[name]
