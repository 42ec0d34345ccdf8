"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` (Hopper), one
`nvcc -c` per source, all started together, then linked into one shared
library with a plain C interface, loaded with `ctypes`. The build runs at
the first kernel launch of a process, never at import, into
`garment4d_tpu_torch/_build/` (ignored by git), named by a hash of the
sources and flags so that an edited source never loads a stale library.
Processes that start together build it once: one compiles under a file
lock, the others wait and load its result.

Each C entry point takes device pointers and the CUDA stream as `void*`,
sizes as `int` and radii as `float`, and returns `cudaGetLastError()`;
`check` raises on anything but 0. There is no fallback: a missing `nvcc`, a
failed build or a failed launch raises.

`launch_counts` counts kernel launches by kernel name. Each wrapper in
`ops/pointcloud.py`, `ops/pemax.py`, `ops/graph.py` and
`models/skinning.py` adds one where it launches its kernel and nowhere
else, so a run can show which kernels its main path went through (the
PE-backward wrapper counts its two launches, the per-block pass and the
ordered sum of the partials, as one, the scatter-add its sort and its
segmented sum as one; the flat ball query, the 3-NN and the 1-NN count
their sort pre-pass, where their plans run it, under `ball_query_sort`,
`three_nn_sort` and `nn1_sort` beside `ball_query`, `three_nn` and
`nn1`; the PE backward's
dtable half's scatter-add counts under `scatter_add`).
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_IP = ctypes.POINTER(ctypes.c_int)     # host array of ints
# C signatures of the entry points (all return int = cudaError_t)
_SIGNATURES = {
    "g4d_fps": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "g4d_gather_rows": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _I, _U, _I, _P, _P),
    "g4d_ball_query": (_P, _P, _I, _I, _I, _I, _F, _I, _P, _F, _I, _P, _F, _I, _P,
                       _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "g4d_ball_query_grouped": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _F,
                               _I, _P, _F, _I, _P, _I, _I, _I, _P),
    "g4d_three_nn": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "g4d_fused_chain": (_P, _P, _P, _P, _P, _I, _I, _I, _IP, _I, _I, _I, _P, _P, _P, _P),
    "g4d_coverage": (_P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P, _P),
    "g4d_knn_transfer": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _P),
    "g4d_gcn_layer": (_PP, _IP, _I, _IP, _I, _I, _I, _I, _P, _IP, _IP, _I, _I, _I, _P, _P,
                      _I, _I, _I, _I, _I, _P, _P),
    "g4d_pe_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "g4d_banded": (_P, _IP, _I, _P, _I, _I, _I, _P, _P),
    "g4d_nn1": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "g4d_scatter_add": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
}

# shared memory, in bytes, that one block may use on the H100, and that
# each of two blocks resident on one SM may use
SMEM_LIMIT = 232448
SMEM_TWO_BLOCKS = 112 * 1024

launch_counts: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if not built


def reset_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
            "garment4d_tpu_torch cannot be built")
    return str(path)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> list:
    """Run the commands concurrently; (cmd, returncode, output) each."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    return [(cmd, proc.returncode, out) for cmd, proc, out in
            ((c, p, p.communicate()[0]) for c, p in zip(cmds, procs))]


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *[str(o) for o in objs]]
    log = target.with_suffix(".log")
    results = _run_all(cmds)
    failed = [r for r in results if r[1] != 0]
    if not failed:
        results += _run_all([link])
        failed = [r for r in results if r[1] != 0]
    log.write_text("".join(" ".join(c) + "\n" + out for c, _, out in results))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, code, out = failed[0]
        raise RuntimeError(f"nvcc failed (exit {code}) on {cmd[-1]}; see {log}:\n"
                           + out[-4000:])
    os.replace(tmp, target)  # atomic: a concurrent build never sees a partial file


def build_once(target: Path, compile_fn=None) -> bool:
    """Build `target` with `compile_fn` (default `_compile`) unless it
    exists, holding an exclusive `fcntl` lock on a file beside it, so that
    of several processes starting together (the ranks of a data-parallel
    run) one compiles and the others wait and load its result. Returns
    whether this process compiled."""
    if target.exists():
        return False
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / ".build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():
                return False
            (compile_fn or _compile)(target)
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libg4d_kernels_{_digest()}.so"
            t0 = time.perf_counter()
            if build_once(target):
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (with ptxas register/spill lines) of the loaded build."""
    log = BUILD_DIR / f"libg4d_kernels_{_digest()}.log"
    return log.read_text() if log.exists() else ""


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pitch(k: int) -> int:
    """`k` channels rounded up to a whole number of float4s."""
    return (k + 3) // 4 * 4


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd records and an input requires grad: a kernel's
    output has no grad_fn, so the gradient would stop there silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only and an input requires "
            f"grad; run it under torch.no_grad() or torch.inference_mode(), "
            f"or differentiate the plain versions inside ops.plain_ops()")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of rank `ndim` on
    the CUDA `device` (what every kernel entry point takes)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
