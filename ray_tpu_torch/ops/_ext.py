"""Build and bind the hand-written CUDA kernels in ``ray_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C entry point, and bound with ``ctypes``. No
source includes PyTorch's headers: such a build takes minutes, a plain C
one seconds. The sources are compiled in parallel, at first use, into
``ray_tpu_torch/_build/`` (git-ignored), under a name that hashes the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is.

Nothing here runs when the module is imported: the CPU tests import it on
machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from .._private import locksan

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library name -> (source file, C entry point)
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", "rtt_flash_fwd"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "rtt_flash_bwd_dq"),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu", "rtt_flash_bwd_dkv"),
}
# every header a kernel includes: an edit to one rebuilds the kernels
_HEADERS = ("flash_common.cuh", "hopper_common.cuh")
# a launcher's return code for a tensor map it could not encode (+ CUresult)
ERR_TENSOR_MAP = 10000

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]


class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in ``csrc/flash_common.cuh``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv")]
        + [(f"{t}_{s}", ctypes.c_longlong)
           for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
           for s in ("sb", "sh", "ss")]
        + [(n, ctypes.c_int) for n in ("B", "H", "Hk", "Sq", "Sk", "D")]
        + [("scale", ctypes.c_float), ("causal", ctypes.c_int),
           ("out_f32", ctypes.c_int)]
    )


_lock = locksan.lock("ext.build")
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_log: List[str] = []   # nvcc's -Xptxas -v output of the last build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of ray_tpu_torch are built from source")
    return found


def _target(name: str) -> Path:
    src, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None, ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Compile the kernels that are not built yet, one ``nvcc`` per source,
    all started together. Returns name -> library path; raises with the
    compiler's output if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                    else []),
               "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log.append(f"[{name}] {log}")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def kernel(name: str):
    """The C entry point of kernel `name`, building and loading its library
    on first use: ``fn(ctypes.byref(FlashParams), stream) -> cudaError_t``."""
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def load_all(ptxas_verbose: bool = False) -> Dict[str, Path]:
    """Build every kernel (in parallel) and load it; returns the paths."""
    with _lock:
        paths = build(ptxas_verbose=ptxas_verbose)
    for name in KERNELS:
        kernel(name)
    return paths
