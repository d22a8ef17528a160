"""Build, load and count the hand-written CUDA kernels of `csrc/`.

The kernels are CUDA C++ for Hopper (`sm_90a`) with a plain C interface,
compiled by `nvcc` into one shared library and called through `ctypes`:
pointers from `tensor.data_ptr()`, the stream from PyTorch's current stream.
The library is built at first use, from the sources in this checkout only,
into `build/kernels/<digest>/` beside the package (listed in `.gitignore`);
the digest covers the sources and the flags, so an edited source rebuilds.
Every `.cu` compiles in its own `nvcc` process, all started together, and
one more `nvcc` links the objects.

Float semantics are part of each kernel's contract (see `csrc/score.cuh`):
no `--use_fast_math`, and `-fmad=false` on top of the explicitly rounded
intrinsics, so a kernel rounds exactly as its plain PyTorch version does.

One stream: every kernel of the port launches on the device's current
stream as PyTorch reports it (`stream()`), which is the default stream of
the device in every thread, since the port creates no side streams. The
served worker launches K2-K5 from its dispatch thread while its build
thread may launch K4b; one stream keeps the chain, the refresh, the
table snapshots and the device->host copies in the order they were issued.

Pinned host memory: K4b reads its refresh block, and K5 writes its outputs,
in pinned host memory through the address CUDA maps it at for the device
(`device_address`), so neither needs a copy between host and device. CUDA
does not know of such a kernel's reads or writes, and neither does
PyTorch's caching host allocator, which records no event for them: the
owner of a pinned buffer must keep it alive until an event recorded after
the kernel has completed (the node table's staging ring, the served
worker's drain plan).

Nothing here falls back: without `nvcc` or a card, `library()` raises, and
so does `device_address` for memory that is not pinned or not mapped.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("keyed.cu", "chain.cu", "refresh.cu", "compact.cu", "mesh.cu",
           "host.cu")
HEADERS = ("score.cuh", "select.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

# One count per kernel wrapper: LAUNCHES moves only where the wrapper
# launches its kernel, PLAIN_CALLS only where its plain PyTorch version runs.
KERNELS = ("score_topk", "merge_candidates", "placement_chain",
           "scatter_refresh", "compact_window", "mesh_pack", "apply_ring",
           "cold_packet", "pool_build", "warm_finish")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_CALLS: Dict[str, int] = {k: 0 for k in KERNELS}

# Comparison runs only: while set, the composites of scheduler/kernels.py and
# the node table's refresh run each kernel's plain PyTorch version on the
# card instead of launching the kernel (PLAIN_CALLS counts them). Set only
# through `plain_versions()`; nothing in the package sets it.
plain_on_card = False

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Within the block, run the plain versions on the card (see
    `plain_on_card`). Not thread-safe: for a comparison run of one thread."""
    global plain_on_card
    plain_on_card = True
    try:
        yield
    finally:
        plain_on_card = False


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "nomad_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.blake2b(digest_size=12)
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the library if this source digest has not been built yet;
    returns its path. Objects compile in parallel, one nvcc per source."""
    global build_seconds
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libnomad_kernels.so"
    if lib_path.exists():
        return lib_path
    t0 = time.monotonic()
    nvcc = _nvcc()
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    failures = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    tmp_lib = work / lib_path.name
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
           *[str(work / (Path(s).stem + ".o")) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed:\n$ {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.monotonic() - t0
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    "nomad_score_topk": [_P] * 8 + [_F, _I, _I, _I, _I, _I] + [_P] * 5 + [_P],
    "nomad_merge_candidates": [_P, _P, _I, _I, _I, _I, _I] + [_P] * 6 + [_P],
    "nomad_placement_chain": [_P] * 11 + [_F, _I, _I, _I, _I, _I, _I]
    + [_P] * 12 + [_L, _P],
    "nomad_scatter_refresh": [_P, _I, _I, _I, _P, _P, _P, _P],
    "nomad_compact_window": [_P, _P, _P, _I, _I] + [_P] * 4 + [_P],
    "nomad_mesh_pack": [_P] * 5 + [_I, _I, _P, _P],
    "nomad_apply_ring": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "nomad_cold_packet": [_P, _P, _P, _L, _P, _F] + [_I] * 7 + [_P] * 8
    + [_P],
    "nomad_pool_build": [_P, _I, _I, _I, _P, _P, _I, _I, _I] + [_P] * 12
    + [_P],
    "nomad_warm_finish": [_P] * 11 + [_I, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I] + [_P] * 5 + [_I, _P],
    "nomad_host_device_ptr": [_P, ctypes.POINTER(ctypes.c_void_p)],
    "nomad_empty": [_P],
}
# Entries that return a byte count (int64) rather than a cudaError_t.
_SIZES = {
    "nomad_select_work_bytes": [_I],
    "nomad_placement_chain_work_bytes": [_I, _I, _I],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def device_address(t: torch.Tensor, device: torch.device) -> int:
    """The address at which a kernel on `device` reaches t's data: t's own
    pointer for a tensor on that card, the mapped device address for a
    pinned CPU tensor (CUDA's answer, never assumed to be the host
    pointer; CUDA also says whether the memory is pinned). Anything else
    raises: a pageable CPU tensor is never copied behind the caller's
    back."""
    if t.device.type == "cuda":
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, kernel on {device}")
        return t.data_ptr()
    if t.device.type != "cpu":
        raise ValueError(f"a kernel on {device} reaches only tensors on the "
                         f"card or in pinned host memory, not {t.device}")
    base = t.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    err = library().nomad_host_device_ptr(base, ctypes.byref(dev))
    if err != 0 or not dev.value:
        raise ValueError(f"a kernel on {device} reaches only tensors on the "
                         f"card or in pinned host memory: CUDA maps no "
                         f"device address for host memory at {base:#x} "
                         f"(pageable, or pinned but not mapped; cudaError "
                         f"{err})")
    return dev.value + (t.data_ptr() - base)


def stream(device: torch.device) -> int:
    """The device's current stream as a raw handle: what
    `torch.cuda.current_stream(device).cuda_stream` gives, without building
    a Stream object (a few microseconds of every launch's host time)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(name: str, err: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
