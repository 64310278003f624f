"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``lightgbm_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew.
Nothing builds when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

from ..utils.log import LightGBMError

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"

# kernel name -> source, relative to this directory
SOURCES: Dict[str, str] = {
    "predict_stream": "csrc/predict_stream.cu",
    # K1's leaf form (pred_leaf): another entry point of the same source,
    # its own library
    "predict_leaf": "csrc/predict_stream.cu",
    "route_and_hist": "csrc/route_and_hist.cu",
    # K2's int form (quantized gradients): another entry point of the
    # same source, its own library
    "route_and_hist_int": "csrc/route_and_hist.cu",
    "leaf_gather": "csrc/leaf_gather.cu",
    "route_replay": "csrc/route_replay.cu",
    # K5 and K8 are two entry points of one source, each its own library
    "scatter_hist": "csrc/hist_rows.cu",
    # K6 and K7 are two entry points of one source, each its own library
    "hist_direct": "csrc/hist_sorted.cu",
    "hist_nibble": "csrc/hist_sorted.cu",
    "hist_wide": "csrc/hist_rows.cu",
    # raw rows to group bins (no TPU kernel: the native host binner's
    # counterpart)
    "bin_rows": "csrc/bin_rows.cu",
    # SciPy CSR rows to group bins (no TPU kernel: the counterpart of the
    # JAX package's host construct_binned_sparse)
    "bin_csr": "csrc/bin_csr.cu",
    # TreeSHAP (pred_contrib; no pallas_call: the JAX package's device
    # TreeSHAP is a jitted lax.scan)
    "tree_shap": "csrc/tree_shap.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel name -> flags of its own.  tree_shap's twelve instantiations
# unroll a body per path length: its optimisations run on every core of
# the host (chip_smoke.py's build, NVCC 12.9 on an 8-core host: 128 s
# without, 49 s with; the same registers and stack bytes)
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "tree_shap": ("--split-compile=0", "-Xptxas", "--split-compile=0"),
}

_c_ptr, _c_int, _c_i64, _c_f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_float)
# the two entry points of csrc/hist_sorted.cu take the same arguments
_SORTED_ARGS = [_c_ptr, _c_int, _c_i64, _c_int, _c_ptr, _c_ptr, _c_int,
                _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_f32,
                _c_f32, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
# C signature of each library's entry point: (symbol, argtypes).  Every
# kernel that reads bins takes them as a pointer and their width in bytes
# (1: uint8, 2: 16-bit)
SIGNATURES = {
    "predict_stream": ("lgbt_predict_stream",
                       [_c_ptr, _c_int, _c_i64, _c_int, _c_ptr, _c_ptr,
                        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_f32,
                        _c_ptr, _c_ptr, _c_ptr]),
    "predict_leaf": ("lgbt_predict_leaf",
                     [_c_ptr, _c_int, _c_i64, _c_int, _c_ptr, _c_ptr, _c_ptr,
                      _c_int, _c_int, _c_int, _c_ptr, _c_i64, _c_int, _c_int,
                      _c_ptr, _c_ptr]),
    "route_and_hist": ("lgbt_route_and_hist",
                       [_c_ptr, _c_int, _c_i64, _c_int, _c_int, _c_ptr,
                        _c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr,
                        _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                        _c_ptr]),
    "route_and_hist_int": ("lgbt_route_and_hist_int",
                           [_c_ptr, _c_int, _c_i64, _c_int, _c_int, _c_ptr,
                            _c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr,
                            _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr]),
    "leaf_gather": ("lgbt_leaf_gather",
                    [_c_ptr, _c_i64, _c_ptr, _c_int, _c_ptr, _c_ptr]),
    "route_replay": ("lgbt_route_replay",
                     [_c_ptr, _c_int, _c_i64, _c_int, _c_ptr, _c_int, _c_int,
                      _c_ptr, _c_ptr, _c_ptr, _c_ptr]),
    "scatter_hist": ("lgbt_scatter_hist",
                     [_c_ptr, _c_int, _c_i64, _c_int, _c_ptr, _c_ptr, _c_ptr,
                      _c_ptr, _c_int, _c_int, _c_f32, _c_f32, _c_ptr, _c_ptr,
                      _c_ptr, _c_ptr]),
    "hist_direct": ("lgbt_hist_direct", _SORTED_ARGS),
    "hist_nibble": ("lgbt_hist_nibble", _SORTED_ARGS),
    "hist_wide": ("lgbt_hist_wide",
                  [_c_ptr, _c_int, _c_i64, _c_int, _c_int, _c_ptr, _c_ptr,
                   _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr,
                   _c_ptr, _c_ptr]),
    "bin_rows": ("lgbt_bin_rows",
                 [_c_ptr, _c_i64, _c_int, _c_ptr, _c_int, _c_ptr, _c_int,
                  _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr,
                  _c_int, _c_i64, _c_i64, _c_int, _c_ptr, _c_ptr]),
    "bin_csr": ("lgbt_bin_csr",
                [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_int, _c_ptr, _c_int,
                 _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int,
                 _c_ptr, _c_ptr, _c_ptr, _c_int, _c_i64, _c_i64, _c_int,
                 _c_ptr, _c_ptr, _c_ptr]),
    "tree_shap": ("lgbt_tree_shap",
                  [_c_ptr, _c_i64, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                   _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,
                   _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr]),
}

_LOADED: Dict[str, ctypes.CDLL] = {}
# kernel name -> the wait of its build started with ``wait=False``
_PENDING: Dict[str, Callable[[], Dict[str, float]]] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise LightGBMError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                        "of lightgbm_torch are built from source at first use")


def library_path(name: str) -> Path:
    """Where the kernel's library is built: named by a hash of its source,
    every header under csrc/ and its flags."""
    h = hashlib.sha256((_HERE / SOURCES[name]).read_bytes())
    for header in sorted((_HERE / "csrc").glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, wait: bool = True):
    """Compile every named kernel not built yet, all nvcc processes started
    together.  Returns seconds per kernel built (the compiler's ``-Xptxas
    -v`` report goes to ``_build/<name>.log``); raises on a failed build.
    ``wait=False`` returns at once a function that waits for the builds and
    returns the same; ``load`` waits for a kernel's pending build."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names
            if not library_path(n).exists() and n not in _PENDING]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(n, ()), "-o", str(tmp),
               str(_HERE / SOURCES[n])]
        log = open(BUILD_DIR / f"{n}.log", "wb")
        procs[n] = (subprocess.Popen(cmd, stdout=log,
                                     stderr=subprocess.STDOUT), tmp, out, log)
    seconds: Dict[str, float] = {}

    def finish() -> Dict[str, float]:
        failed = []
        for n, (proc, tmp, out, log) in procs.items():
            if n in seconds:
                continue
            rc = proc.wait()
            log.close()
            _PENDING.pop(n, None)
            seconds[n] = time.perf_counter() - t0
            if rc != 0:
                failed.append(n)
                continue
            os.replace(tmp, out)
        if failed:
            logs = "\n".join((BUILD_DIR / f"{n}.log").read_text(
                errors="replace") for n in failed)
            raise LightGBMError(f"nvcc failed for {failed}:\n{logs}")
        return dict(seconds)

    if wait:
        return finish()
    for n in procs:
        _PENDING[n] = finish
    return finish


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed, with its entry point's
    argtypes and restype set."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if name in _PENDING:
            _PENDING[name]()
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check_operands(name: str, dev, operands) -> None:
    """Each (label, tensor, dtype) must be a contiguous tensor of that dtype
    on the CUDA device ``dev``."""
    if dev.type != "cuda":
        raise LightGBMError(f"{name}: the CUDA kernel takes CUDA tensors, "
                            f"got {dev}")
    for label, x, dtype in operands:
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise LightGBMError(
                f"{name}: {label} must be a contiguous {dtype} tensor on "
                f"{dev}, got {x.dtype} on {x.device}")


def init_counts(wrapper) -> None:
    """Give a CUDA wrapper its launch counts: ``launches`` (every launch)
    and ``wide_launches`` (those over 16-bit bins)."""
    wrapper.launches = 0
    wrapper.wide_launches = 0


def count_launch(wrapper, bin_width: int) -> None:
    """Count one launch of the wrapper's kernel over bins of ``bin_width``
    bytes a bin."""
    wrapper.launches += 1
    if bin_width == 2:
        wrapper.wide_launches += 1
