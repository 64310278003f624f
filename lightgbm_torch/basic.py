"""Dataset and Booster — the user-facing objects of the port.

The port's counterpart of ``lightgbm_tpu/basic.py`` (reference:
python-package/lightgbm/basic.py, Dataset :1692, Booster :3495), trimmed to
in-memory data, training, evaluation, prediction and the model's methods.
A Dataset holds a numpy array, a pandas DataFrame or a SciPy sparse matrix
(kept as CSR: its mappers and EFB groups from its sampled stored values,
its bins filled on the device by ``kernels/bin_csr.py``), or loads a
``save_binary`` file of either package; validation data is binned with
its training Dataset's mappers (``reference=``, ``create_valid``), and
``subset`` takes rows (``cv``'s folds).  ``group=`` query sizes and
``position=`` display positions serve ranking.  The Booster trains
(``update``, one boosting iteration; ``rollback_one_iter``;
``reset_parameter`` between iterations), evaluates its validation sets,
holds a model (dump, edit, shuffle, reload) and predicts.
``Booster.predict`` on at least ``_DEVICE_PREDICT_MIN_ROWS`` rows of a
Booster built on a training Dataset uploads the raw rows, bins them there
with the training mappers (``kernels/bin_rows.py``, or ``bin_csr.py`` for
SciPy rows) and walks every tree on the device (``kernels/predict.py``:
raw scores, or with ``pred_leaf`` each row's leaf in each tree); smaller
batches and Boosters loaded from a model file alone take the host float64
walk, as in the reference (SciPy rows in dense slabs).  ``pred_contrib``
runs the float64 TreeSHAP kernel (``kernels/tree_shap.py``) on the
Booster's device when the trees are numeric and at most
``kernels.tree_shap.MAX_DEPTH`` deep, whatever the batch, else the exact
host walk (``shap.py``); SciPy rows go to it in dense slabs.  A text data
file (CSV, LibSVM) is not ported yet and raises.

Device rule: a Dataset is constructed on ``device_type`` (default
``"cuda"``), and with no GPU that raises; ``device_type="cpu"`` runs the
device path's plain PyTorch version on the CPU.
"""
from __future__ import annotations

import json
import os
import struct
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .binning import (BinMapper, BinnedData, construct_binned,
                      construct_binned_sparse, device_group_order,
                      find_bin_mappers, find_bin_mappers_sparse,
                      find_feature_groups, load_forced_bins,
                      sample_sparse_csc, sparse_nz_masks)
from .config import Config, resolve_aliases
from .device_data import (DeviceData, build_routing_np, resolve_device,
                          to_device)
from .kernels.bin_csr import bin_csr_matrix
from .kernels.bin_rows import bin_matrix, bin_tables
from .kernels.layout import bins_to_numpy
from .kernels.predict import (build_predict_tables, predict_leaf,
                              predict_stream, tables_to_device)
from .metrics import create_metrics
from .objectives import create_objective
from .robustness.checkpoint import atomic_open
from .shap import device_depth, predict_contrib, predict_contrib_device
from .utils.log import LightGBMError, log_warning, set_verbosity


# values in one dense slab of a SciPy sparse predict on the host walk
# (~256 MB of float64)
_SPARSE_SLAB_VALUES = 1 << 25
# the per-row fields of a Dataset (get_field / set_field, binary files)
_LABEL_FIELDS = ("label", "weight", "group", "init_score", "position")


def _is_scipy_sparse(data) -> bool:
    """A SciPy sparse matrix (scipy is imported only if installed)."""
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    return sp.issparse(data)


def _to_2d_float(data, align_categories=None
                 ) -> Tuple[np.ndarray, Optional[List[str]], List[int],
                            Optional[List[list]]]:
    """Coerce a numpy array or a pandas DataFrame to a 2-D float64 array;
    returns (array, feature names or None, the indices of the frame's
    category columns, the frame's category lists or None) (reference:
    lightgbm_tpu/basic.py:44-135, the DataFrame branch; python-package
    basic.py _data_from_pandas).

    A category column becomes its codes, -1 (missing) as NaN.
    ``align_categories``, the TRAINING frame's category lists (by category
    column), recodes a validation or predict frame through them, so that
    codes agree with training whatever the frame's category order; a
    category training did not see becomes NaN.  pandas is imported only
    for a DataFrame."""
    if hasattr(data, "dtypes") and hasattr(data, "columns"):
        import pandas as pd
        feature_names = [str(c) for c in data.columns]
        df = data.copy()
        cat_idx: List[int] = []
        cat_lists: List[list] = []
        for i, col in enumerate(df.columns):
            if isinstance(df[col].dtype, pd.CategoricalDtype):
                if align_categories is not None \
                        and len(cat_lists) < len(align_categories):
                    train_cats = align_categories[len(cat_lists)]
                    frame_cats = list(df[col].cat.categories)
                    strs = [str(c) for c in frame_cats]
                    if (train_cats and frame_cats
                            and all(isinstance(t, str) for t in train_cats)
                            and not set(train_cats) & set(frame_cats)
                            and len(set(strs)) == len(strs)):
                        # a model file's lists hold non-JSON categories
                        # (datetimes) as strings: match those by str(),
                        # unless two stringify alike (then unseen)
                        df[col] = df[col].cat.rename_categories(strs)
                    df[col] = df[col].cat.set_categories(train_cats)
                cat_lists.append(list(df[col].cat.categories))
                codes = df[col].cat.codes.astype(np.float64)
                df[col] = codes.where(codes >= 0, np.nan)  # unseen -> NaN
                cat_idx.append(i)
            elif df[col].dtype == object:
                raise LightGBMError(f"DataFrame column {col!r} has object "
                                    "dtype; convert to numeric or "
                                    "categorical first")
        if align_categories is not None \
                and len(cat_lists) != len(align_categories):
            # positional alignment of other columns would code wrongly
            raise LightGBMError(
                f"DataFrame has {len(cat_lists)} categorical columns but "
                f"the training data had {len(align_categories)}; "
                "categorical columns must match training")
        arr = df.to_numpy(dtype=np.float64, na_value=np.nan)
        # an empty list (a frame with no category column) stays apart from
        # None (not a frame), so the count check above still fires
        return arr, feature_names, cat_idx, cat_lists
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise LightGBMError(f"data must be 2-D, got shape {arr.shape}")
    return arr, None, [], None


class Dataset:
    """Training dataset with lazy binning (reference: basic.py:1692).

    ``data`` is a numpy array, a pandas DataFrame, a SciPy sparse matrix
    (kept as CSR: mappers and EFB groups from its sampled stored values on
    the host, its bins filled on the device by ``kernels/bin_csr.py``), or
    the path of a file written by ``save_binary`` (either package's
    format); a text data file (CSV, LibSVM) is not ported yet and raises.
    ``free_raw_data=True`` drops the raw rows once the bins exist."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 reference: Optional["Dataset"] = None, group=None,
                 position=None, free_raw_data: Optional[bool] = None):
        self.params = dict(params or {})
        self.reference = reference
        self.free_raw_data = free_raw_data
        self._feature_name_arg = feature_name
        self._categorical_feature_arg = categorical_feature
        self._resolved_feature_names: Optional[List[str]] = None
        self.binned: Optional[BinnedData] = None
        self.device: Optional[torch.device] = None
        self._device_data: Optional[DeviceData] = None
        # the (N, G) bins made on the device, until to_device takes them
        self._device_bins: Optional[torch.Tensor] = None
        # the seconds of the last construct's stages (mappers, groups, bins)
        self.construct_times: Dict[str, float] = {}
        # the user's DataFrame (get_data, set_reference's realignment)
        self._raw_container = None
        self.raw_data: Optional[np.ndarray] = None
        self.raw_sparse = None
        self._pandas_names: Optional[List[str]] = None
        self._pandas_cat_idx: List[int] = []
        self.pandas_categorical = None
        if isinstance(data, (str, Path)):
            if not self._is_binary_file(data):
                raise LightGBMError(
                    f"loading a data file ({data}) is not yet ported to "
                    "lightgbm_torch: pass an array, a DataFrame, a SciPy "
                    "sparse matrix or a save_binary file")
            if reference is not None:
                raise LightGBMError(
                    "a binary dataset file carries its own bin mappers; "
                    "reference= cannot be combined with it")
            self._load_binary(str(data))
            # explicit arguments override the stored metadata
            for field, value in (("label", label), ("weight", weight),
                                 ("init_score", init_score),
                                 ("group", group), ("position", position)):
                if value is not None:
                    self.set_field(field, value)
            if isinstance(feature_name, list):
                self._resolved_feature_names = [str(x) for x in feature_name]
            return
        if _is_scipy_sparse(data):
            self.raw_sparse = data.tocsr()
            self.num_data_, self.num_feature_ = self.raw_sparse.shape
        else:
            # a DataFrame's category columns are categorical features,
            # coded through the reference's category lists (reference:
            # basic.py:350-354)
            align = (reference.pandas_categorical if reference is not None
                     else None)
            (self.raw_data, self._pandas_names, self._pandas_cat_idx,
             self.pandas_categorical) = _to_2d_float(data, align)
            if self._pandas_names is not None:
                self._raw_container = data
            self.num_data_, self.num_feature_ = self.raw_data.shape
        self.set_label(label)
        self.set_weight(weight)
        self.set_init_score(init_score)
        # ranking: the query sizes in row order, and each row's display
        # position (position-debiased lambdarank); a validation set carries
        # its own
        self.set_group(group)
        self.set_position(position)

    _BINARY_MAGIC = b"LGBTPU.BIN.v2\n"
    _BINARY_MAGIC_V1 = b"LGBTPU.BIN.v1\n"

    @classmethod
    def _is_binary_file(cls, path) -> bool:
        try:
            with open(path, "rb") as f:
                magic = f.read(len(cls._BINARY_MAGIC))
                return magic in (cls._BINARY_MAGIC, cls._BINARY_MAGIC_V1)
        except OSError:
            return False

    def _resolve_categorical(self) -> List[int]:
        """The frame's category columns, then those the argument names
        (reference: basic.py:456-470)."""
        arg = self._categorical_feature_arg
        names = self.feature_name()
        cats = list(self._pandas_cat_idx)
        if arg == "auto" or arg is None or arg == "":
            return cats
        for c in (arg if isinstance(arg, (list, tuple)) else [arg]):
            if isinstance(c, str):
                if c in names:
                    cats.append(names.index(c))
                else:
                    log_warning(f"categorical_feature {c!r} not found in "
                                "features")
            else:
                cats.append(int(c))
        return sorted(set(cats))

    def feature_name(self) -> List[str]:
        if self._resolved_feature_names is not None:
            return self._resolved_feature_names
        arg = self._feature_name_arg
        if isinstance(arg, list):
            names = [str(x) for x in arg]
        elif self._pandas_names is not None:
            names = list(self._pandas_names)
        else:
            names = [f"Column_{i}" for i in range(self.num_feature_)]
        self._resolved_feature_names = names
        return names

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this Dataset with ``reference``'s mappers, adopting its
        feature names and categorical spec; a DataFrame's category codes
        are made again through the reference's category lists (reference:
        lightgbm_tpu/basic.py:489-516).  Before ``construct`` only."""
        if self.binned is not None and reference is not self.reference:
            raise LightGBMError(
                "Cannot set reference after the Dataset has been "
                "constructed; build a new Dataset instead")
        self.reference = reference
        self._feature_name_arg = "auto"
        self._resolved_feature_names = None
        if reference._resolved_feature_names is not None or \
                isinstance(reference._feature_name_arg, list):
            self._resolved_feature_names = list(reference.feature_name())
        self._categorical_feature_arg = reference._categorical_feature_arg
        if self._raw_container is not None and reference.pandas_categorical:
            (self.raw_data, self._pandas_names, self._pandas_cat_idx,
             self.pandas_categorical) = _to_2d_float(
                self._raw_container, reference.pandas_categorical)
        return self

    def get_data(self):
        """The data this Dataset was made from: the user's DataFrame, the
        array or the CSR matrix; raises once freed or for a binary file."""
        for v in (self._raw_container, self.raw_data, self.raw_sparse):
            if v is not None:
                return v
        raise LightGBMError(
            "Cannot access raw data: it was freed (free_raw_data=True) or "
            "the Dataset was loaded from a binary file")

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Replace the categorical spec (before ``construct`` only)."""
        if self.binned is not None and \
                categorical_feature != self._categorical_feature_arg:
            raise LightGBMError(
                "Cannot change categorical_feature after the Dataset has "
                "been constructed; build a new Dataset instead")
        self._categorical_feature_arg = categorical_feature
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """The set of Datasets reachable through ``reference`` from this
        one."""
        head, chain = self, set()
        while head is not None and len(chain) < ref_limit:
            if head in chain:
                break
            chain.add(head)
            head = head.reference
        return chain

    def _should_free_raw(self) -> bool:
        return bool(self.free_raw_data)

    def construct(self) -> "Dataset":
        """Resolve the device, then bin on it: dense rows through
        ``kernels/bin_rows.py``, CSR rows through ``kernels/bin_csr.py``,
        the bins copied back once for the host copy (reference: the
        in-memory dense and sparse paths of lightgbm_tpu/basic.py
        :651-708).  A Dataset loaded from a binary file only resolves its
        device."""
        if self.binned is not None:
            if self.device is None:
                self.device = resolve_device(
                    Config.from_params(self.params).device_type)
            return self
        if self.num_data_ == 0:
            raise LightGBMError("Cannot construct Dataset: it has no rows")
        if self.reference is not None:
            ref = self.reference.construct()
            if ref.num_feature() != self.num_feature_:
                raise LightGBMError(
                    f"The number of features in data ({self.num_feature_}) "
                    f"is not the same as in the reference Dataset "
                    f"({ref.num_feature()})")
            self.device = ref.device
            self._bin(ref.binned.bin_mappers, ref.binned.group_features)
        else:
            self._construct_own(Config.from_params(self.params))
        if self._should_free_raw():
            self.raw_data = self.raw_sparse = self._raw_container = None
        return self

    def _construct_own(self, cfg: Config) -> None:
        """Mappers and EFB groups from this Dataset's own rows, on the
        host, then its bins."""
        self.device = resolve_device(cfg.device_type)
        cats = self._resolve_categorical()
        t0 = time.perf_counter()
        mapper_kw = dict(
            max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
            categorical_features=cats, use_missing=cfg.use_missing,
            zero_as_missing=cfg.zero_as_missing,
            sample_cnt=cfg.bin_construct_sample_cnt,
            seed=cfg.data_random_seed,
            max_bin_by_feature=cfg.max_bin_by_feature,
            forced_bins=load_forced_bins(cfg.forcedbins_filename,
                                         self.num_feature_, cats))
        groups = None
        if self.raw_sparse is not None:
            # the sample rows of the dense path (same seed and draw), so
            # that the bundles, and the model, are those of the dense rows
            sample = sample_sparse_csc(self.raw_sparse,
                                       cfg.bin_construct_sample_cnt,
                                       cfg.data_random_seed)
            mappers = find_bin_mappers_sparse(self.raw_sparse, **mapper_kw,
                                              sample=sample)
            t1 = time.perf_counter()
            if cfg.enable_bundle:
                masks = sparse_nz_masks(*sample, mappers)
                groups = find_feature_groups(None, mappers,
                                             enable_bundle=True,
                                             nz_masks=masks)
                del masks
            del sample
        else:
            mappers = find_bin_mappers(self.raw_data, **mapper_kw)
            t1 = time.perf_counter()
            if cfg.enable_bundle:
                sample_n = min(self.num_data_, cfg.bin_construct_sample_cnt)
                rng = np.random.RandomState(cfg.data_random_seed)
                idx = (np.arange(self.num_data_)
                       if self.num_data_ <= sample_n else
                       np.sort(rng.choice(self.num_data_, sample_n,
                                          replace=False)))
                sample_bins = [mappers[f].transform(self.raw_data[idx, f])
                               for f in range(self.num_feature_)]
                groups = find_feature_groups(sample_bins, mappers,
                                             enable_bundle=True)
                del sample_bins
        t2 = time.perf_counter()
        self._bin(mappers, groups)
        self.construct_times.update(mappers=t1 - t0, groups=t2 - t1)

    def _bin(self, mappers, groups) -> None:
        """The rows' bins under ``mappers`` and ``groups``, made on the
        Dataset's device (``bin_rows``, or ``bin_csr`` for CSR rows) and
        kept there for ``device_data``."""
        t0 = time.perf_counter()
        if groups is None:
            groups = [[f] for f in range(self.num_feature_)]
        groups = device_group_order(groups, mappers)
        tables = bin_tables(mappers, groups, self.device)
        if self.raw_sparse is not None:
            bins = bin_csr_matrix(self.raw_sparse, tables)
            self.binned = construct_binned_sparse(
                self.raw_sparse, mappers, groups, bins=bins_to_numpy(bins))
        else:
            bins = bin_matrix(self.raw_data, tables)
            self.binned = construct_binned(self.raw_data, mappers, groups,
                                           bins=bins_to_numpy(bins))
        self._device_bins = bins
        self.construct_times["bins"] = time.perf_counter() - t0

    def device_data(self) -> DeviceData:
        if self._device_data is None:
            self.construct()
            self._device_data = to_device(self.binned, self.device,
                                          bins=self._device_bins)
            self._device_bins = None
        return self._device_data

    def bin_mappers(self):
        self.construct()
        return self.binned.bin_mappers

    def num_data(self) -> int:
        return self.num_data_

    def num_feature(self) -> int:
        return self.num_feature_

    def get_label(self) -> Optional[np.ndarray]:
        return self.label

    def get_weight(self) -> Optional[np.ndarray]:
        return self.weight

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.init_score

    def get_group(self) -> Optional[np.ndarray]:
        return self.group

    def get_position(self) -> Optional[np.ndarray]:
        return self.position

    def set_label(self, label) -> "Dataset":
        self.label = (None if label is None
                      else np.asarray(label, np.float64).reshape(-1))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = (None if weight is None
                       else np.asarray(weight, np.float64).reshape(-1))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, np.float64))
        return self

    def set_group(self, group) -> "Dataset":
        self.group = (None if group is None
                      else np.asarray(group, np.int64).reshape(-1))
        return self

    def set_position(self, position) -> "Dataset":
        self.position = (None if position is None
                         else np.asarray(position, np.int32).reshape(-1))
        return self

    def get_field(self, field_name: str):
        if field_name not in _LABEL_FIELDS:
            raise LightGBMError(f"Unknown field {field_name}")
        return getattr(self, field_name)

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name not in _LABEL_FIELDS:
            raise LightGBMError(f"Unknown field {field_name}")
        return getattr(self, f"set_{field_name}")(data)

    def get_query_boundaries(self) -> Optional[np.ndarray]:
        """(nq + 1,) cumulative query boundaries, or None without a group.
        The rows past ``num_data`` that the device pads to belong to no
        query."""
        if self.group is None:
            return None
        qb = np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)
        if qb[-1] != self.num_data_ or (len(self.group)
                                        and self.group.min() < 0):
            raise LightGBMError(
                f"sum of group sizes ({int(qb[-1])}) does not match the "
                f"number of rows ({self.num_data_})")
        return qb

    def get_label_padded(self, n: int) -> Optional[np.ndarray]:
        if self.label is None:
            return None
        out = np.zeros(n, np.float64)
        out[:len(self.label)] = self.label
        return out

    def get_init_score_padded(self, n: int, k: int) -> Optional[np.ndarray]:
        if self.init_score is None:
            return None
        s = self.init_score
        if k == 1:
            out = np.zeros(n, np.float32)
            out[:len(s)] = s.reshape(-1)
        else:
            s2 = s.reshape(self.num_data_, k) if s.ndim == 1 and s.size == self.num_data_ * k \
                else s.reshape(-1, k) if s.ndim == 2 else np.tile(s.reshape(-1, 1), (1, k))
            out = np.zeros((n, k), np.float32)
            out[:s2.shape[0]] = s2
        return out

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None,
                     position=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, weight=weight,
                       init_score=init_score, params=params or self.params,
                       reference=self, group=group, position=position)

    def subset(self, used_indices, params=None) -> "Dataset":
        """A Dataset of the rows ``used_indices`` (dense or CSR), binned
        with this Dataset's mappers (reference: lightgbm_tpu/basic.py
        :1033-1063).  Indices that take whole queries, in increasing order,
        keep those queries' sizes."""
        if self.raw_data is None and self.raw_sparse is None:
            raise LightGBMError("cannot subset after raw data was freed")
        idx = np.asarray(used_indices, np.int64)
        group_sub = None
        if self.group is not None and len(idx) and np.all(np.diff(idx) > 0):
            bounds = np.concatenate([[0], np.cumsum(self.group)]) \
                .astype(np.int64)
            q_of = np.searchsorted(bounds, idx, side="right") - 1
            sel_q, counts = np.unique(q_of, return_counts=True)
            if np.array_equal(counts, bounds[sel_q + 1] - bounds[sel_q]):
                group_sub = counts

        def rows(a):
            if a is None:
                return None
            return a[idx] if a.ndim == 1 else a[idx, :]

        return Dataset(
            (self.raw_data if self.raw_data is not None
             else self.raw_sparse)[idx],
            label=rows(self.label), weight=rows(self.weight),
            init_score=rows(self.init_score),
            feature_name=self._feature_name_arg,
            categorical_feature=self._categorical_feature_arg,
            params=params or self.params,
            reference=(self if self.binned is not None
                       else self.reference or self),
            group=group_sub)

    def save_binary(self, filename) -> "Dataset":
        """Write the binned Dataset: the JAX package's ``LGBTPU.BIN.v2``
        format, a JSON header and an npz archive of plain arrays
        (lightgbm_tpu/basic.py:1068-1118), so either package loads the
        other's files.  Load it by passing the path to ``Dataset``."""
        self.construct()
        b = self.binned
        mappers = b.bin_mappers
        arrays = {
            "bins": b.bins,
            "group_offsets": np.asarray(b.group_offsets, np.int64),
            "group_bin_counts": np.asarray(b.group_bin_counts, np.int64),
            "feature_offsets": np.asarray(b.feature_offsets, np.int64),
            "feature_num_bins": np.asarray(b.feature_num_bins, np.int64),
            "mapper_ub": (np.concatenate(
                [np.asarray(m.upper_bounds, np.float64).reshape(-1)
                 for m in mappers]) if mappers else np.zeros(0)),
            "mapper_ub_len": np.asarray(
                [np.asarray(m.upper_bounds).size for m in mappers], np.int64),
            "mapper_cats": (np.concatenate(
                [np.asarray(m.categories, np.int64).reshape(-1)
                 for m in mappers]) if mappers else np.zeros(0, np.int64)),
            "mapper_cats_len": np.asarray(
                [np.asarray(m.categories).size for m in mappers], np.int64),
        }
        for field in _LABEL_FIELDS:
            v = getattr(self, field)
            if v is not None:
                arrays[field] = np.asarray(v)
        meta = {
            "num_data": int(self.num_data_),
            "num_feature": int(self.num_feature_),
            "feature_names": self.feature_name(),
            "group_features": [list(map(int, g)) for g in b.group_features],
            "mappers": [[int(m.bin_type), int(m.missing_type),
                         int(m.num_bins), int(m.default_bin),
                         int(m.most_freq_bin), float(m.min_val),
                         float(m.max_val)] for m in mappers],
        }
        meta_b = json.dumps(meta).encode()
        with atomic_open(str(filename), "wb") as f:
            f.write(self._BINARY_MAGIC)
            f.write(struct.pack("<Q", len(meta_b)))
            f.write(meta_b)
            np.savez(f, **arrays)
        return self

    def _load_binary(self, path: str) -> None:
        """Restore a ``save_binary`` file; the raw rows are not in it
        (lightgbm_tpu/basic.py:1120-1179).  The v1 pickle format is
        refused."""
        try:
            file_size = os.path.getsize(path)
            with open(path, "rb") as f:
                magic = f.read(len(self._BINARY_MAGIC))
                if magic == self._BINARY_MAGIC_V1:
                    raise LightGBMError(
                        "this binary dataset uses the deprecated v1 pickle "
                        "format, which is unsafe to load; re-save it with "
                        "Dataset.save_binary() from this release")
                header = f.read(8)
                if len(header) != 8:
                    raise LightGBMError(f"truncated binary dataset: {path}")
                (meta_len,) = struct.unpack("<Q", header)
                if meta_len > file_size:
                    raise LightGBMError(f"corrupt binary dataset: {path}")
                meta = json.loads(f.read(meta_len).decode())
                blob = np.load(f, allow_pickle=False)
                blob = {k: blob[k] for k in blob.files}
        except LightGBMError:
            raise
        except Exception as exc:  # struct, json and zipfile errors
            raise LightGBMError(
                f"failed to load binary dataset {path}: {exc}") from exc
        mappers = []
        ub_off = cat_off = 0
        for i, ms in enumerate(meta["mappers"]):
            bt, mt, nb, db, mfb = ms[:5]
            mn, mx = (ms[5], ms[6]) if len(ms) > 6 else (0.0, 0.0)
            ub_n = int(blob["mapper_ub_len"][i])
            cat_n = int(blob["mapper_cats_len"][i])
            mappers.append(BinMapper(
                upper_bounds=blob["mapper_ub"][ub_off:ub_off + ub_n],
                bin_type=bt, missing_type=mt,
                categories=blob["mapper_cats"][cat_off:cat_off + cat_n],
                num_bins=nb, default_bin=db, most_freq_bin=mfb,
                min_val=mn, max_val=mx))
            ub_off += ub_n
            cat_off += cat_n
        self.binned = BinnedData(
            bins=blob["bins"],
            group_features=meta["group_features"],
            group_offsets=blob["group_offsets"],
            group_bin_counts=blob["group_bin_counts"],
            feature_offsets=blob["feature_offsets"],
            feature_num_bins=blob["feature_num_bins"],
            bin_mappers=mappers,
            num_data=meta["num_data"], num_features=meta["num_feature"])
        for field in _LABEL_FIELDS:
            setattr(self, field, blob.get(field))
        self.num_data_ = meta["num_data"]
        self.num_feature_ = meta["num_feature"]
        self._resolved_feature_names = meta["feature_names"]

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s columns to this Dataset's (dense raw rows on
        both); the next ``construct`` bins anew."""
        if self.raw_data is None or other.raw_data is None:
            raise LightGBMError("add_features_from requires raw data")
        self.raw_data = np.hstack([self.raw_data, other.raw_data])
        self.num_feature_ = self.raw_data.shape[1]
        self.binned = None
        self._device_data = self._device_bins = None
        self._resolved_feature_names = None
        return self


class DevicePredictInputs:
    """What one device batch prediction launches: the (G, N) bins and, per
    class, the tables on the device and the depths of its trees."""

    def __init__(self, n: int, bins_T: torch.Tensor, classes, es_freq: int,
                 es_margin: float):
        self.n = n
        self.bins_T = bins_T
        self.classes = classes   # [(nodes, leaf_value, cat_words, depths)]
        self.es_freq = es_freq
        self.es_margin = es_margin


class Booster:
    """Booster (reference: basic.py:3495). Wraps the boosting engine."""

    _DEVICE_PREDICT_MIN_ROWS = 20_000

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[Union[str, Path]] = None,
                 model_str: Optional[str] = None):
        params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._engine = None
        self._loaded_trees = None
        self._train_data_name = "training"
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a lightgbm_torch.Dataset")
            self.params = resolve_aliases(params)
            cfg = Config.from_params(params)
            set_verbosity(cfg.verbosity)
            # merge dataset params (dataset params win for binning keys)
            train_set.params = {**params, **train_set.params}
            train_set.construct()
            objective = create_objective(cfg)
            if objective is not None:
                if train_set.get_label() is None:
                    raise LightGBMError("training requires labels")
                objective.init(
                    train_set.get_label(), train_set.get_weight(),
                    query_boundaries=train_set.get_query_boundaries(),
                    position=train_set.get_position(),
                    n=train_set.num_data())
            metrics = self._init_metrics(cfg, objective, train_set)
            from .models.gbdt import create_boosting
            self._engine = create_boosting(cfg, train_set, objective,
                                           metrics)
            self.config = cfg
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            # a model alone predicts on the host, as in the reference: the
            # device path needs a training Dataset's bin mappers
            from .model_io import load_model_string
            if model_file is not None:
                model_str = Path(model_file).read_text()
            self._loaded_trees = load_model_string(model_str)
            self.params = params
            self.config = Config.from_params(params)
        else:
            raise LightGBMError("need train_set or model_file/model_str")

    @staticmethod
    def _init_metrics(cfg, objective, data):
        metrics = create_metrics(cfg, objective.name if objective else "none")
        label = data.get_label()
        for m in metrics:
            m.init(label if label is not None else np.zeros(data.num_data()),
                   data.get_weight(), data.get_query_boundaries())
        return metrics

    @property
    def engine(self):
        if self._engine is None:
            raise LightGBMError("Booster was loaded from a model file; "
                                "training operations unavailable")
        return self._engine

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True when training cannot go on
        (reference: Booster.update, basic.py:4005).  ``fobj(score,
        train_set)`` gives custom gradients of the unpadded training score:
        (N,) arrays, or for K trees per iteration (N, K) ones, the layout of
        the (N, K) score it is handed, as the JAX package takes them
        (lightgbm_tpu/basic.py:1279-1283)."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("changing train_set after construction is "
                                "not supported")
        eng = self.engine
        if fobj is not None:
            score = eng.score[:eng.num_data].cpu().numpy()
            grad, hess = fobj(score, self.train_set)
            return eng.train_one_iter(np.asarray(grad, np.float32),
                                      np.asarray(hess, np.float32))
        return eng.train_one_iter()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters from the next iteration on (reference:
        Booster.reset_parameter; lightgbm_tpu/basic.py:1917-1934).  A
        parameter the port does not train raises, as at construction."""
        resolved = resolve_aliases(params)
        self.engine.reset_config(resolved)
        self.params.update(resolved)
        return self

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores (reference:
        Booster.rollback_one_iter, basic.py:4092)."""
        self.engine.rollback_one_iter()
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` after every iteration (reference:
        Booster.add_valid, basic.py:3852).  A Dataset not binned yet is
        binned with the training Dataset's mappers."""
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be a Dataset instance, "
                            f"met {type(data).__name__}")
        if data is not self.train_set:
            if data.binned is None and data.reference is None:
                data.reference = self.train_set
            data.construct()
            if not _mappers_compatible(data.binned.bin_mappers,
                                       self.train_set.binned.bin_mappers):
                raise LightGBMError(
                    "cannot add validation data, since it has different bin "
                    "mappers with training data (construct it with "
                    "reference=train_set)")
        self.engine.add_valid(data, name,
                              self._init_metrics(self.config,
                                                 self.engine.objective, data))
        return self

    def eval_train(self, feval=None) -> List:
        """[(dataset name, metric, value, higher is better)] of the training
        data."""
        eng = self.engine
        name = self._train_data_name
        return [(name, m, v, hb) for _, m, v, hb in eng.eval_train()] + \
            self._run_feval(feval, name, self.train_set,
                            eng.score_to_host(eng.score, eng.num_data))

    def eval_valid(self, feval=None) -> List:
        eng = self.engine
        out = eng.eval_valid()
        for vi, vset in enumerate(eng.valid_sets):
            score = eng.score_to_host(eng.valid_scores[vi], vset.num_data())
            out.extend(self._run_feval(feval, eng.valid_names[vi], vset,
                                       score))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """[(name, metric, value, higher is better)] of a validation set
        added with ``add_valid`` (reference: lightgbm_tpu/basic.py:1350)."""
        eng = self.engine
        for vi, vset in enumerate(eng.valid_sets):
            if vset is data:
                score = eng.score_to_host(eng.valid_scores[vi],
                                          vset.num_data())
                conv = eng._convert()
                out = [(name, mn, v, hb) for m in eng.valid_metrics[vi]
                       for mn, v, hb in m.evaluate(score, conv)]
                return out + self._run_feval(feval, name, vset, score)
        raise LightGBMError("eval() requires the dataset to be added via "
                            "add_valid")

    @staticmethod
    def _run_feval(feval, name, dset, raw_score) -> List:
        if feval is None:
            return []
        out = []
        for f in (feval if isinstance(feval, list) else [feval]):
            res = f(raw_score, dset)
            for mn, v, hb in ([res] if isinstance(res, tuple) else res):
                out.append((name, mn, float(v), bool(hb)))
        return out

    def current_iteration(self) -> int:
        if self._engine is not None:
            return self.engine.iter_
        lt = self._loaded_trees
        return len(lt.trees) // max(lt.num_tree_per_iteration, 1)

    def num_trees(self) -> int:
        return len(self._all_trees())

    def num_model_per_iteration(self) -> int:
        if self._engine is not None:
            return self.engine.num_tree_per_iteration
        return self._loaded_trees.num_tree_per_iteration

    def _all_trees(self):
        if self._engine is not None:
            return self.engine.models
        return self._loaded_trees.trees

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                validate_features: bool = False, **kwargs) -> np.ndarray:
        """Predict (reference: Booster.predict, basic.py:4625): raw scores
        or their transform, each row's leaf in each tree (``pred_leaf``,
        (N, trees) int32), or SHAP contributions (``pred_contrib``, (N, F +
        1), (N, K (F + 1)) for K classes).  ``validate_features`` is taken
        and, as in the JAX package, not read."""
        if isinstance(data, Dataset):
            raise LightGBMError("predict() takes raw data, not a Dataset")
        use, k, _, _ = self._resolve_tree_slice(start_iteration, num_iteration)
        early_stop = bool(kwargs.get("pred_early_stop", False))
        # freq < 1 would never fire (and 0 would crash the modulo); clamp
        es_freq = max(int(kwargs.get("pred_early_stop_freq", 10)), 1)
        es_margin = float(kwargs.get("pred_early_stop_margin", 10.0))
        es = (es_freq, es_margin) if early_stop else None
        if _is_scipy_sparse(data):
            X = data.tocsr()
            if (pred_contrib or self._device_cat_features(
                    X.shape[0], use, k, None if pred_leaf else es) is None):
                # the host walk and TreeSHAP read real values: rows are
                # made dense a bounded slab at a time (~256 MB; reference:
                # lightgbm_tpu/basic.py:1392-1404)
                chunk = max(1, _SPARSE_SLAB_VALUES // max(1, X.shape[1]))
                starts = range(0, X.shape[0], chunk) if X.shape[0] else [0]
                return np.concatenate([self.predict(
                    np.asarray(X[s:s + chunk].todense(), np.float64),
                    start_iteration, num_iteration, raw_score, pred_leaf,
                    pred_contrib, validate_features, **kwargs)
                    for s in starts], axis=0)
            # the whole batch is binned on the device by bin_csr
        else:
            X, _, _, _ = _to_2d_float(data, self._pandas_categorical())
        expected = self.num_feature()
        if expected and X.shape[1] != expected:
            raise LightGBMError(
                f"The number of features in data ({X.shape[1]}) is not the same "
                f"as it was in training data ({expected})")
        if pred_leaf:
            return self._predict_leaf(X, use, k)
        if pred_contrib:
            return self._predict_contrib(X, use, k)
        # init scores are folded into tree 0 at training time (AddBias), so a
        # plain sum over trees is the complete raw score
        score = self._try_device_predict(X, use, k, es=es)
        if score is None:
            score = _host_predict(X, use, k, early_stop, es_freq, es_margin)
        if self._average_output() and len(use):
            score = score / max(len(use) // max(k, 1), 1)
        if raw_score:
            return score
        return np.asarray(self._convert_output_fn()(score))

    def _resolve_tree_slice(self, start_iteration: int,
                            num_iteration: Optional[int]):
        """Iteration-window resolution (best_iteration fallback + end clamp);
        returns (trees, k, start, end)."""
        trees = self._all_trees()
        k = self.num_model_per_iteration()
        n_total = len(trees) // max(k, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = (self.best_iteration
                             if self.best_iteration
                             and self.best_iteration > 0 else n_total)
        end = min(start_iteration + num_iteration, n_total)
        return trees[start_iteration * k:end * k], k, start_iteration, end

    def _device_cat_features(self, n, use, k, es=None):
        """The categorical features the trees split on, or None when the
        device batch path does not apply to n rows: a small batch, no
        engine, linear trees, early stop with k > 1, a bundled categorical
        feature (which EFB never makes)."""
        if self._engine is None or not use \
                or n < self._DEVICE_PREDICT_MIN_ROWS:
            return None
        if es is not None and k != 1:
            return None
        cat_feats = set()
        for t in use:
            if t.is_linear:
                return None    # linear leaves: the host walk only
            ni = max(t.num_leaves - 1, 0)
            if ni:
                dt = np.asarray(t.decision_type[:ni]).astype(np.int64)
                for f in np.asarray(t.split_feature[:ni])[(dt & 1) > 0]:
                    cat_feats.add(int(f))
        routing_np, _ = build_routing_np(self.engine.train_data.binned)
        for f in cat_feats:
            # the NaN/unseen sentinel bin below needs the cat feature alone
            # in its group.  Not reached: EFB never bundles a categorical
            # feature (binning.py), but a bundle's span could not hold the
            # sentinel, so such a model would walk on the host
            if routing_np["bundled"][f]:
                return None
        return cat_feats

    def _device_predict_inputs(self, X, use, k, es=None, times=None):
        """Upload the raw rows, bin them on the device with the training
        mappers (the predict forms of ``kernels/bin_rows.py`` for a dense
        matrix and of ``kernels/bin_csr.py`` for a SciPy CSR one) and build
        the device tensors of a batch walk, or None when the device path
        does not apply (``_device_cat_features``).  Bins wider than uint8
        (groups wider than 256 bins, or a categorical sentinel bin past
        255) go to K1 as 16-bit bins.
        The reference's VMEM-size gates (basic.py:1569-1576, :1633) do not
        apply: on the GPU the tables sit in device memory and L2.  A dict
        passed as ``times`` receives the seconds of its stages: ``tables``
        (the binning and walk tables built and copied to the device),
        ``upload`` (the raw rows copied to the device) and ``binning`` (the
        binning kernel)."""
        cat_feats = self._device_cat_features(X.shape[0], use, k, es)
        if cat_feats is None:
            return None
        L = max(max(t.num_leaves for t in use), 2)
        eng = self.engine
        tb = eng.train_data.binned
        routing_np, _ = build_routing_np(tb)
        t0 = time.perf_counter()
        dev = eng.device
        # the host walk routes NaN / unseen / negative categories RIGHT
        # (bit absent from the bitset); the mapper bins them to bin 0 (the
        # most frequent category), so the predict form bins those values
        # of split categorical features to the sentinel bin one past the
        # span, whose bitset bit is always zero by construction
        # (build_predict_tables), in 16-bit bins where it passes 255
        bin_tabs = bin_tables(tb.bin_mappers, tb.group_features, dev,
                              sentinel=cat_feats)
        host_tables = [build_predict_tables(use[c::k], routing_np, L,
                                            tb.bin_mappers) for c in range(k)]
        classes = [(*tables_to_device(t, dev), t.depths) for t in host_tables]
        t1 = time.perf_counter()
        stages = {} if times is not None else None
        binner = bin_csr_matrix if _is_scipy_sparse(X) else bin_matrix
        bins_T = binner(X, bin_tabs, transpose=True, times=stages)
        if times is not None:
            times.update(tables=t1 - t0, **stages)
        es_freq, es_margin = (int(es[0]), float(es[1])) if es else (0, 0.0)
        return DevicePredictInputs(X.shape[0], bins_T, classes, es_freq,
                                   es_margin)

    def _try_device_predict(self, X, use, k, es=None):
        """Batched device prediction (kernels/predict.py): one launch per
        class over all rows.  Returns float64 raw scores, or None when the
        device path does not apply (see _device_predict_inputs)."""
        inp = self._device_predict_inputs(X, use, k, es)
        if inp is None:
            return None
        outs = [predict_stream(inp.bins_T, nodes, lv, words, depths,
                               inp.es_freq, inp.es_margin)
                for nodes, lv, words, depths in inp.classes]
        host = [o.cpu().numpy() for o in outs]
        if k == 1:
            return host[0].astype(np.float64)
        return np.stack(host, axis=1).astype(np.float64)

    def _predict_leaf(self, X, use, k) -> np.ndarray:
        """(N, trees) int32 leaf indices: K1's leaf form, one launch per
        class, where the device batch path applies (the bins and tables of
        ``_device_predict_inputs``); else the host walk of each tree
        (lightgbm_tpu/basic.py:1414-1418)."""
        inp = self._device_predict_inputs(X, use, k)
        if inp is None:
            out = np.zeros((X.shape[0], len(use)), np.int32)
            for i, t in enumerate(use):
                out[:, i] = t.predict_leaf_raw(X)
            return out
        out = torch.empty((inp.n, len(use)), dtype=torch.int32,
                          device=inp.bins_T.device)
        for c, (nodes, lv, words, depths) in enumerate(inp.classes):
            predict_leaf(inp.bins_T, nodes, lv, words, depths, out, c, k)
        return out.cpu().numpy()

    def _predict_contrib(self, X, use, k) -> np.ndarray:
        """SHAP contributions: the device TreeSHAP on the Booster's device
        when every tree is numeric and 0 < depth <= tree_shap.MAX_DEPTH,
        else the exact host walk.  No batch size gates the device path:
        the JAX package's rows x trees gate kept small batches off its
        float32 kernel (lightgbm_tpu/shap.py:501-516), and this kernel is
        float64 and, on the card, faster than the host walk from one row
        (chip_smoke.py phase predict_surface, its ``gate`` timings).  A
        kernel that fails to build or launch raises."""
        depth = device_depth(use)
        if depth:
            dev = (self.engine.device if self._engine is not None
                   else resolve_device(self.config.device_type))
            return predict_contrib_device(use, X, k, dev, depth)
        return predict_contrib(use, X, k)

    def _pandas_categorical(self):
        """The training frame's category lists, which a predict frame's
        codes are aligned to (reference: basic.py:1663-1669)."""
        if self._engine is not None:
            return self.engine.train_data.pandas_categorical
        return self._loaded_trees.pandas_categorical

    def _average_output(self) -> bool:
        if self._engine is not None:
            return self.engine._average_output
        return self._loaded_trees.average_output

    def _convert_output_fn(self):
        if self._engine is not None and self.engine.objective is not None:
            return self.engine.objective.convert_output
        if self._loaded_trees is not None:
            return self._loaded_trees.convert_output
        return lambda x: x

    def save_model(self, filename: Union[str, Path],
                   num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        """Write the model text; tmp + os.replace, so a reader never sees a
        torn file."""
        text = self.model_to_string(num_iteration, start_iteration,
                                    importance_type)
        tmp = f"{filename}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, str(filename))
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        from .model_io import save_model_string
        return save_model_string(self, num_iteration, start_iteration,
                                 importance_type)

    def checkpoint(self, output_model: str, iteration: Optional[int] = None,
                   keep: int = -1) -> str:
        """Write a crash-consistent checkpoint that ``train(...,
        resume_from=...)`` resumes: the model text, the engine state (the
        score, the RNG streams, the objective's state) and a sealed JSON
        manifest, each through a tmp file and ``os.replace``, pruned to the
        ``keep`` newest (reference: lightgbm_tpu/basic.py:1718-1733).  A
        snapshot that ``serve_fleet_dir``'s promotion pointer names is
        never pruned.  Returns the snapshot path."""
        from .robustness.checkpoint import write_checkpoint
        it = (int(iteration) if iteration is not None
              else self.current_iteration())
        fleet_dir = str(self.params.get("serve_fleet_dir", "") or "")
        return write_checkpoint(self, str(output_model), it, keep=keep,
                                fleet_dir=fleet_dir)

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster with this model's trees and leaf values refitted
        on ``data`` and ``label``: each leaf becomes ``decay_rate`` times
        its value plus ``1 - decay_rate`` times the Newton step of the new
        rows that reach it (reference: Booster.refit; lightgbm_tpu/basic.py
        :1966-1968).  The host path: ``refit.refit_leaf_values`` does the
        same on a Dataset through K3."""
        from .model_io import refit_model
        return refit_model(self, data, label, decay_rate, **kwargs)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict:
        """The model as a JSON-ready dict (reference: GBDT::DumpModel)."""
        from .model_io import dump_model_dict
        return dump_model_dict(self, num_iteration, start_iteration,
                               importance_type)

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this Booster's model with one parsed from ``model_str``,
        in place: the engine is dropped and ``best_iteration`` reset
        (reference: basic.py:4445)."""
        from .model_io import load_model_string
        self._loaded_trees = load_model_string(model_str)
        self._engine = None
        self.best_iteration = -1
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """The training set's name in ``eval_train`` (reference:
        basic.py set_train_data_name)."""
        self._train_data_name = name
        return self

    def trees_to_dataframe(self):
        """The parsed model as a pandas DataFrame, one row per node, with
        the reference's column set (reference: basic.py:3775)."""
        try:
            import pandas as pd
        except ImportError as exc:
            raise LightGBMError(
                "trees_to_dataframe requires pandas") from exc
        if self.num_trees() == 0:
            raise LightGBMError(
                "There are no trees in this Booster and thus nothing to parse")
        model = self.dump_model()
        feat_names = model["feature_names"]
        rows: List[Dict[str, Any]] = []

        def node_index(node, ti):
            if "split_index" in node:
                return f"{ti}-S{node['split_index']}"
            return f"{ti}-L{node.get('leaf_index', 0)}"

        def walk(node, ti, depth, parent):
            idx = node_index(node, ti)
            if "split_index" in node:
                f = node["split_feature"]
                rows.append({
                    "tree_index": ti, "node_depth": depth, "node_index": idx,
                    "left_child": node_index(node["left_child"], ti),
                    "right_child": node_index(node["right_child"], ti),
                    "parent_index": parent,
                    "split_feature": (feat_names[f]
                                      if f < len(feat_names) else str(f)),
                    "split_gain": node["split_gain"],
                    "threshold": node["threshold"],
                    "decision_type": node["decision_type"],
                    "missing_direction": ("left" if node.get("default_left")
                                          else "right"),
                    "missing_type": node.get("missing_type"),
                    "value": node["internal_value"],
                    "weight": node["internal_weight"],
                    "count": node["internal_count"]})
                walk(node["left_child"], ti, depth + 1, idx)
                walk(node["right_child"], ti, depth + 1, idx)
            else:
                rows.append({
                    "tree_index": ti, "node_depth": depth, "node_index": idx,
                    "left_child": None, "right_child": None,
                    "parent_index": parent, "split_feature": None,
                    "split_gain": np.nan, "threshold": np.nan,
                    "decision_type": None, "missing_direction": None,
                    "missing_type": None,
                    "value": node["leaf_value"],
                    "weight": node.get("leaf_weight"),
                    "count": node.get("leaf_count")})

        for ti, tree in enumerate(model["tree_info"]):
            walk(tree["tree_structure"], ti, 1, None)
        return pd.DataFrame(rows)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The value of one leaf (reference: basic.py:4883)."""
        return float(self._all_trees()[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """Overwrite one leaf's value (reference: Tree::SetLeafOutput via
        LGBM_BoosterSetLeafValue).  Every predict builds its device tables
        from the trees anew, so the edit reaches the next prediction on
        every path; under a live engine the training and validation scores
        keep their history, as in the reference."""
        t = self._all_trees()[tree_id]
        lv = np.asarray(t.leaf_value, np.float64).copy()
        lv[leaf_id] = value
        t.leaf_value = lv
        return self

    def lower_bound(self) -> float:
        """Lower bound of the raw scores: each tree's least leaf value,
        summed (reference: GBDT::GetLowerBoundValue)."""
        return float(sum(float(np.min(t.leaf_value))
                         for t in self._all_trees()) or 0.0)

    def upper_bound(self) -> float:
        """Upper bound of the raw scores (reference:
        GBDT::GetUpperBoundValue)."""
        return float(sum(float(np.max(t.leaf_value))
                         for t in self._all_trees()) or 0.0)

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in [start, end) (reference:
        GBDT::ShuffleModels) with a local RandomState seeded from
        ``data_random_seed``, the JAX package's formula, so both give the
        same order and the global numpy state is untouched."""
        trees = self._all_trees()
        k = self.num_model_per_iteration()
        n_iter = len(trees) // max(k, 1)
        end = n_iter if end_iteration <= 0 else min(end_iteration, n_iter)
        seed = int(self.params.get("data_random_seed", 1) or 1)
        rng = np.random.RandomState((seed * 65539 + start_iteration * 9973
                                     + max(end, 0)) % (2 ** 31 - 1))
        idx = np.arange(start_iteration, end)
        rng.shuffle(idx)
        order = list(range(n_iter))
        order[start_iteration:end] = [int(i) for i in idx]
        new_trees = []
        for it in order:
            new_trees.extend(trees[it * k:(it + 1) * k])
        trees[:] = new_trees
        return self

    def free_dataset(self) -> "Booster":
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        trees = self._all_trees()
        if iteration is not None and iteration > 0:
            trees = trees[:iteration * self.num_model_per_iteration()]
        imp = np.zeros(self.num_feature(), np.float64)
        for t in trees:
            for i in range(t.num_leaves - 1):
                f = int(t.split_feature[i])
                if importance_type == "split":
                    imp[f] += 1.0
                else:
                    imp[f] += float(t.split_gain[i])
        if importance_type == "split":
            return imp.astype(np.int32)
        return imp

    def num_feature(self) -> int:
        if self._engine is not None:
            return self.train_set.num_feature()
        return self._loaded_trees.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        if self._engine is not None:
            return self.train_set.feature_name()
        return self._loaded_trees.feature_names


def _mappers_compatible(a, b) -> bool:
    """True when two bin-mapper lists bin alike (reference: the CheckAlign
    of GBDT::AddValidDataset)."""
    if a is b:
        return True
    return len(a) == len(b) and all(
        ma.bin_type == mb.bin_type
        and np.array_equal(np.asarray(ma.upper_bounds),
                           np.asarray(mb.upper_bounds))
        for ma, mb in zip(a, b))


def _host_predict(X, use, k, early_stop, es_freq, es_margin) -> np.ndarray:
    """The float64 host walk, tree by tree (reference: basic.py:1447-1481,
    prediction_early_stop.cpp CreateBinary / CreateMulticlass)."""
    n = X.shape[0]
    score = np.zeros(n, np.float64) if k == 1 else np.zeros((n, k), np.float64)
    active = np.ones(n, bool)
    all_active = True
    for i, t in enumerate(use):
        col = (slice(None),) if k == 1 else (slice(None), i % k)
        if early_stop and not all_active:
            score[(active,) + col[1:]] += t.predict_raw(X[active])
        else:
            score[col] += t.predict_raw(X)
        if early_stop and (i + 1) % (es_freq * k) == 0:
            if k == 1:
                # rows whose margin 2|score| clears the threshold stop
                # accumulating further trees
                active &= ~(2.0 * np.abs(score) > es_margin)
            else:
                # top-1 minus top-2 margin
                part = np.partition(score, -2, axis=1)
                active &= ~(part[:, -1] - part[:, -2] > es_margin)
            all_active = bool(active.all())
            if not active.any():
                break
    return score
