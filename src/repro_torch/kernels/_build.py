"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -shared -Xcompiler -fPIC -Xptxas -v  [per-source flags]

The two float64 kernels of the offer path add ``--fmad=false``, which
keeps nvcc from contracting a multiply and an add into one FMA: they are
held bit-identical to float64 numpy references, which round after every
operation. The model kernels (rmsnorm, both flash attention routes) are
held to a tolerance and build without it (rmsnorm's backward too). The library lands in ``build/``
next to this file (ignored by git), named by a hash of the source and
its flags, so an edited source is rebuilt and an unchanged one is loaded.
No PyTorch headers are included, which keeps a build to seconds.
Nothing is fetched; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every source, with the flags it adds to ``NVCC_FLAGS``
SOURCES: Dict[str, Tuple[str, ...]] = {
    "price_bundle": ("--fmad=false",),
    "minplus_sweep": ("--fmad=false",),
    "rmsnorm": (),
    "rmsnorm_bwd": (),
    "flash_attention": (),
    "flash_attention_tc": (),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}
_STAGING: Dict[Tuple[str, int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: nvcc's output (ptxas register/shared-memory report) per source built
#: by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCES[name]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (target, tmp path, process) or None."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, job) -> None:
    target, tmp, proc = job
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)          # atomic: concurrent builders agree


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source that has no library yet, one nvcc per
    source, all started together."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    errors = []
    for n in names:           # wait for every nvcc before raising
        if jobs[n] is not None:
            try:
                _finish(n, jobs[n])
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, returning a
    ``cudaError_t``; resolved once (built on first use)."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def staging(key: str, device: torch.device, n: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pinned host buffer and a device buffer of at least ``n`` float64
    each, kept for ``key`` on ``device`` in the calling thread and reused
    from call to call (grown by doubling). The entries that use them end
    every call with a stream sync, so a later call may overwrite both."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    slot = (key, index, threading.get_ident())
    bufs = _STAGING.get(slot)
    if bufs is None or bufs[0].numel() < n:
        size = max(n, 2 * bufs[0].numel() if bufs is not None else 0, 64)
        bufs = (torch.empty(size, dtype=torch.float64, pin_memory=True),
                torch.empty(size, dtype=torch.float64,
                            device=torch.device("cuda", index)))
        _STAGING[slot] = bufs
    return bufs


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device,
    as a C entry point takes it (one call into torch, without the
    ``torch.cuda.Stream`` object that ``current_stream`` builds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
