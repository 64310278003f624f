"""Device layouts the kernels read: transposed bins and per-leaf route tables.

Counterparts of ``lightgbm_tpu/pallas/stream_kernel.py:496`` ``pack_bins_T``
and ``:758`` ``build_route_tables``.

Bins: the TPU packs four uint8 bins per int32 word, transposed to (GW_pad,
N_pad), because its vector unit works on 32-bit lanes in (8, 128) tiles.
The port keeps one byte per bin, transposed to a contiguous (G, N) uint8
tensor with no padding: the threads of a warp hold neighbouring rows, so
when they read one group they read neighbouring bytes.  The same layout
serves prediction (K1) and training (K2).  Where a group is wider than 256
bins the host bins are uint16, and the card keeps their two bytes a bin as
``torch.int16`` (torch has no uint16 arithmetic): the kernels read those
bytes as ``uint16_t``, and torch ops widen them with ``bin_values``, so
that a bin of 32 768 or more never reads as negative.

Route tables: one record of ROUTE_FIELDS int32 per leaf, the split a round
applies to that leaf's rows.  The TPU tables are float32 rows of 7-bit
digits, gathered per row with a one-hot bf16 matmul that stays exact only
below 256; these are plain int32, read per row by index.  A leaf that is not
split this round has ``chosen = 0`` and only its keep slot is read.  Missing
bins use -1 for "none" (a feature-local bin is never negative).  Categorical
splits read a per-leaf bitset of ceil(Bmax / 32) int32 words: bin b goes left
when bit b is set.  K class trees grown together (batched multiclass) take
(K, L, 16) records and (K, L, W) words, class k's leaves a band of their
own, as the reference stacks K * L records
(``lightgbm_tpu/ops/grow.py:1858-1860``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import LightGBMError

ROUTE_FIELDS = ("chosen", "new_id", "group", "span_start", "default_bin",
                "bundled", "nan_bin", "mz_bin", "num_bins", "threshold",
                "default_left", "is_cat", "slot_left", "slot_right",
                "slot_keep", "unused")
(R_CHOSEN, R_NEWID, R_GROUP, R_SPAN, R_DEFBIN, R_BUNDLED, R_NANBIN, R_MZBIN,
 R_NBINS, R_THR, R_DEFLEFT, R_ISCAT, R_SLOT_L, R_SLOT_R, R_SLOT_KEEP,
 _R_UNUSED) = range(len(ROUTE_FIELDS))


def bins_to_torch(bins: np.ndarray) -> torch.Tensor:
    """The host bins as a CPU tensor of their card storage, the bytes
    unchanged: uint8 as torch.uint8, uint16 as torch.int16."""
    bins = np.ascontiguousarray(bins)
    if bins.dtype == np.uint16:
        return torch.from_numpy(bins.view(np.int16))
    if bins.dtype != np.uint8:
        raise ValueError(f"bins must be uint8 or uint16, got {bins.dtype}")
    return torch.from_numpy(bins)


def bins_to_numpy(bins: torch.Tensor) -> np.ndarray:
    """Bins in card storage (any device) as host bins, the bytes unchanged:
    torch.uint8 as uint8, torch.int16 as uint16 (``bins_to_torch``'s
    inverse)."""
    host = bins.cpu().numpy()
    return host.view(np.uint16) if bins.dtype == torch.int16 else host


def pack_bins_T(bins: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, G) uint8 or uint16 host bins -> (G, N) contiguous on ``device``,
    in their storage dtype (``bins_to_torch``)."""
    return bins_to_torch(bins).to(device).t().contiguous()


def bin_bytes(bins: torch.Tensor) -> int:
    """Bytes a bin of this storage takes, 1 or 2: the width the kernels
    read.  Raises for any other dtype."""
    if bins.dtype == torch.uint8:
        return 1
    if bins.dtype == torch.int16:
        return 2
    raise LightGBMError(f"bins must be torch.uint8 or torch.int16 (16-bit "
                        f"bins), got {bins.dtype}")


def bin_values(bins: torch.Tensor) -> torch.Tensor:
    """int32 bin values of uint8 or int16 (16-bit) bin storage: the int16
    bytes read as unsigned."""
    v = bins.to(torch.int32)
    return v & 0xFFFF if bins.dtype == torch.int16 else v


def build_route_tables(chosen, new_id, feat, threshold, dir_flags,
                       slot_left, slot_right, slot_keep,
                       routing) -> torch.Tensor:
    """(L, 16) int32 route records from (L,) per-leaf tensors: whether the
    leaf splits, the new (right) child's id, the split feature, its bin
    threshold and DIR_* flags (1 default-left, 2 categorical), and the
    histogram slots of the left child, the right child and an unsplit leaf
    (-1 = no histogram).  ``routing`` is the RoutingLayout.  (K, L)
    per-leaf tensors give (K, L, 16) records."""
    shape = tuple(chosen.shape)
    if len(shape) > 1:
        flat = (x.reshape(-1) for x in (chosen, new_id, feat, threshold,
                                        dir_flags, slot_left, slot_right,
                                        slot_keep))
        return build_route_tables(*flat, routing).reshape(
            shape + (len(ROUTE_FIELDS),))
    L = chosen.shape[0]
    f = feat.to(torch.int64)
    tab = torch.zeros((L, len(ROUTE_FIELDS)), dtype=torch.int32,
                      device=chosen.device)
    cols = {R_CHOSEN: chosen, R_NEWID: new_id,
            R_GROUP: routing.feat_group[f], R_SPAN: routing.span_start[f],
            R_DEFBIN: routing.default_bin[f], R_BUNDLED: routing.bundled[f],
            R_NANBIN: routing.nan_bin[f], R_MZBIN: routing.mzero_bin[f],
            R_NBINS: routing.num_bins[f], R_THR: threshold,
            R_DEFLEFT: (dir_flags & 1) != 0, R_ISCAT: (dir_flags & 2) != 0,
            R_SLOT_L: slot_left, R_SLOT_R: slot_right,
            R_SLOT_KEEP: slot_keep}
    for c, v in cols.items():
        tab[:, c] = v.to(torch.int32)
    return tab


def cat_words_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """(L, Bmax) bool left-bin sets -> (L, ceil(Bmax / 32)) int32 words, bit
    b % 32 of word b // 32 set when bin b goes left."""
    L, B = bits.shape
    W = max(-(-B // 32), 1)
    padded = torch.zeros((L, W * 32), dtype=torch.int64, device=bits.device)
    padded[:, :B] = bits.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = (padded.reshape(L, W, 32) * weights).sum(dim=-1)
    # reinterpret the low 32 bits as int32 (bit 31 sets the sign)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)
