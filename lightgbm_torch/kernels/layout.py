"""Device bin layout read by the prediction kernel.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:496`` ``pack_bins_T``.
The TPU packs four uint8 bins per int32 word, transposed to (GW_pad, N_pad),
because its vector unit works on 32-bit lanes in (8, 128) tiles.  The port
keeps one byte per bin, transposed to a contiguous (G, N) uint8 tensor with
no padding: the threads of a warp hold neighbouring rows, so when they sit at
the same split they read neighbouring bytes of one group row, and the kernel
masks the ragged end itself.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_bins_T(bins: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, G) uint8 host bins -> (G, N) uint8 contiguous on ``device``."""
    if bins.dtype != np.uint8:
        raise ValueError(f"pack_bins_T takes uint8 bins, got {bins.dtype}")
    b = torch.as_tensor(np.ascontiguousarray(bins)).to(device)
    return b.t().contiguous()
