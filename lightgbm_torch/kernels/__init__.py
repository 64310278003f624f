"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper launches its kernel for CUDA tensors and the plain
version runs only for CPU tensors.  Importing this package builds nothing:
``build.py`` compiles a kernel at its first launch.

Each CUDA wrapper counts its launches in a plain integer attribute
``launches``; ``launch_counts`` reads them and ``reset_launch_counts`` sets
them to zero, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from . import predict

# kernel name -> its CUDA wrapper
WRAPPERS = {
    "predict_stream": predict.predict_stream_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
