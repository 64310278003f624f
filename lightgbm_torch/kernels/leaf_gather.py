"""The score update's gather, ``values[leaf_id]``: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:714-755``
(``leaf_gather``).  Both versions copy float32 values exactly, so they agree
bit for bit; the caller adds the result to the score in float32, the same
add on every device.  ``leaf_gather`` launches the kernel for tensors on a
CUDA device and runs ``leaf_gather_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from . import build


def leaf_gather(leaf_id: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(N,) float32 values[leaf_id] of (N,) int32 leaf ids and (L,) float32
    values."""
    if leaf_id.device.type == "cuda":
        return leaf_gather_cuda(leaf_id, values)
    if leaf_id.device.type == "cpu":
        return leaf_gather_plain(leaf_id, values)
    raise LightGBMError(f"leaf_gather has no kernel for device "
                        f"{leaf_id.device}")


def leaf_gather_plain(leaf_id: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    return values[leaf_id.to(torch.int64)]


def leaf_gather_cuda(leaf_id: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """Launch csrc/leaf_gather.cu on the current stream."""
    dev = leaf_id.device
    for name, x, dtype in (("leaf_id", leaf_id, torch.int32),
                           ("values", values, torch.float32)):
        if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
                or x.dim() != 1):
            raise LightGBMError(
                f"leaf_gather: {name} must be a contiguous 1-D {dtype} "
                f"tensor on {dev}, got {x.dtype} on {x.device}")
    n = leaf_id.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = build.load("leaf_gather").lgbt_leaf_gather
    rc = fn(leaf_id.data_ptr(), n, values.data_ptr(), values.shape[0],
            out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"leaf_gather kernel launch failed "
                            f"(cudaError {rc})")
    leaf_gather_cuda.launches += 1
    return out


leaf_gather_cuda.launches = 0
