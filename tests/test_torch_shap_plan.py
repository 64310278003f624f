"""The TreeSHAP kernel's launch plan and tables (``kernels/tree_shap.py``,
``csrc/tree_shap.cu``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it to its plain
version, to the host walk and to itself under every plan); here:

- ``shap_plan`` (hypothesis): every row in one tile, every tree in exactly
  one contiguous group, in order; several groups only where the row tiles
  are fewer than BLOCKS_PER_SM blocks an SM and the trees' partial sums fit
  the cap; the smallest path bucket; decision words only where they fit;
  the main path's plans pinned; field orders against the C enums;
- the plain version summed by the tree groups' partials, in tree order,
  equal byte for byte to one group, and within 1e-9 of each row's scale of
  the exact host walk, itself byte-identical to the JAX package's
  (``lightgbm_tpu/shap.py``: tests/test_torch_shap.py);
- the factor tables each the correctly rounded ratio, the kernel's
  compile-time table equal to them bit for bit, the 1 / z table 0
  exactly where z is 0 and elsewhere the correctly rounded 1 / z (within
  one ulp).
"""
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st

import lightgbm_tpu as lgb

import lightgbm_torch as lt
from lightgbm_torch import shap as tshap
from lightgbm_torch.kernels import tree_shap as kts

from chip_smoke import shap_adversarial_rows, shap_adversarial_trees

SRC = Path(kts.__file__).parent / "csrc" / "tree_shap.cu"


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 300_000), T=st.integers(1, 700),
       sm=st.integers(1, 200), F=st.integers(1, 3000),
       L=st.integers(2, 6000), D=st.integers(1, kts.MAX_DEPTH),
       cap=st.sampled_from([0, 1 << 20, kts.PARTIAL_BYTES]))
def test_plan_covers_rows_and_trees_once(n, T, sm, F, L, D, cap):
    p = kts.shap_plan(n, T, sm, F, L, D, cap)
    assert p.threads == kts.THREADS
    assert (p.tiles - 1) * p.threads < n <= p.tiles * p.threads
    groups = [list(range(g * p.trees_per_group,
                         min(T, (g + 1) * p.trees_per_group)))
              for g in range(p.groups)]
    assert all(groups) and sum(groups, []) == list(range(T))
    want = kts.BLOCKS_PER_SM * sm
    if p.groups > 1:
        assert p.tiles < want and 8 * T * F * n <= cap
        assert p.groups <= -(-want // p.tiles)
    else:
        assert p.tiles >= want or T == 1 or 8 * T * F * n > cap
    assert p.groups <= 65535 and p.bucket in kts.BUCKETS
    assert p.bucket >= D and (p.bucket == 8 or p.bucket - 8 < D)
    words = -(-(L - 1) // 32)
    fits = 4 * kts.THREADS * words <= kts.DEC_BYTES
    assert p.dec_words == (words if fits else 0)
    assert p.shared_acc == int(8 * kts.THREADS * F <= kts.ACC_BYTES)
    assert p.smem == (4 * kts.THREADS * p.dec_words
                      + 8 * kts.THREADS * F * p.shared_acc)
    assert p.smem <= kts.DEC_BYTES + kts.ACC_BYTES <= 48 * 1024


def test_main_path_plans_pinned():
    """predict_surface's 20 trees of 255 leaves, 9 deep, over 28 features:
    100 000 rows fill the card in one group (782 tiles); 10 000 rows (79
    tiles) take 10 groups of 2 trees; 8 decision words and 28 accumulators
    a row in shared memory."""
    assert kts.shap_plan(100_000, 20, 132, 28, 255, 9) == kts.ShapPlan(
        threads=128, tiles=782, groups=1, trees_per_group=20, bucket=16,
        dec_words=8, shared_acc=1, smem=32768)
    assert kts.shap_plan(10_000, 20, 132, 28, 255, 9) == kts.ShapPlan(
        threads=128, tiles=79, groups=10, trees_per_group=2, bucket=16,
        dec_words=8, shared_acc=1, smem=32768)
    # one row: a group a tree; trees too big for shared words and rows too
    # wide for shared accumulators: neither
    assert kts.shap_plan(1, 5, 132, 674, 16_384, 24) == kts.ShapPlan(
        threads=128, tiles=1, groups=5, trees_per_group=1, bucket=24,
        dec_words=0, shared_acc=0, smem=0)


def _c_enum(first):
    src = SRC.read_text()
    body = [b for b in re.findall(r"enum \{([^}]*)\}", src) if first in b][0]
    return [w.strip() for w in body.split(",") if w.strip()]


def _camel(name):
    return "".join(w.title() for w in name.split("_"))


def test_fields_follow_the_c_enums():
    assert _c_enum("kPlanThreads") == [
        "kPlan" + _camel(f) for f in kts.SHAP_PLAN_FIELDS] + ["kPlanFields"]
    assert _c_enum("kExtUp") == [
        "k" + _camel(f) for f in kts.FACTOR_TABLES] + ["kFactorTables"]
    consts = dict(re.findall(r"constexpr int (k\w+) = ([\d *]+);",
                             SRC.read_text()))
    assert int(consts["kThreads"]) == kts.THREADS
    assert int(consts["kMaxDepth"]) == kts.MAX_DEPTH
    assert eval(consts["kMaxDecBytes"]) == kts.DEC_BYTES
    assert eval(consts["kMaxAccBytes"]) == kts.ACC_BYTES
    assert re.search(r"bucket != 8 && bucket != 16 && bucket != 24",
                     SRC.read_text())
    assert kts.BUCKETS == (8, 16, 24)


def test_factor_tables_correctly_rounded():
    """Each ratio the correctly rounded quotient of its integers (the C
    side's host division, NumPy's here), 0 outside b < a."""
    f = kts.shap_factors()
    span = kts.MAX_DEPTH + 1
    assert f.shape == (len(kts.FACTOR_TABLES), span, span)
    ratios = (lambda a, b: (b + 1, a + 1), lambda a, b: (a - b, a + 1),
              lambda a, b: (a + 1, b + 1), lambda a, b: (a - b, b + 1),
              lambda a, b: (a + 1, a - b))
    for t, ratio in enumerate(ratios):
        for a in range(span):
            for b in range(span):
                want = float(Fraction(*ratio(a, b))) if b < a else 0.0
                assert f[t, a, b] == want, (kts.FACTOR_TABLES[t], a, b)


def test_kernel_factor_table_is_shap_factors():
    """The kernel's compile-time table (``c_factor``, from the ratio macros
    of csrc/tree_shap.cu, in the order of its initialiser) evaluated here
    as the compiler evaluates it, correctly rounded float64 divisions of
    small integers: equal bit for bit to ``shap_factors``, which the plain
    version reads."""
    src = SRC.read_text()
    macros = dict(re.findall(r"#define ([A-Z_]+)\(a, b\) (.+)", src))
    init = re.search(r"c_factor\[[^]]*\] = \{([^}]*)\}", src).group(1)
    order = re.findall(r"FACTOR_TABLE_\((\w+)\)", init)
    assert order == [t.upper() for t in kts.FACTOR_TABLES]
    assert "#define FACTOR_(t, a, b) ((b) < (a) ? t(a, b) : 0.0)" in src
    row = re.search(r"#define FACTOR_ROW_\(t, a\)((?:.*\\\n)*.*)", src)
    table = re.search(r"#define FACTOR_TABLE_\(t\)((?:.*\\\n)*.*)", src)
    span = kts.MAX_DEPTH + 1
    assert [int(b) for b in re.findall(r"FACTOR_\(t, a, (\d+)\)",
                                       row.group(1))] == list(range(span))
    assert [int(a) for a in re.findall(r"FACTOR_ROW_\(t, (\d+)\)",
                                       table.group(1))] == list(range(span))
    f = kts.shap_factors()
    for t, name in enumerate(order):
        for a in range(span):
            for b in range(span):
                want = eval(macros[name], {"a": a, "b": b}) if b < a else 0.0
                assert f[t, a, b] == want, (name, a, b)


def test_kernel_library_named_by_its_own_flags(monkeypatch):
    """tree_shap builds with flags of its own (``build.EXTRA_FLAGS``), and
    its library's name hashes them, so a change of them builds anew; the
    other kernels' names do not move with them."""
    from lightgbm_torch.kernels import build
    assert "tree_shap" in build.EXTRA_FLAGS
    names = ("tree_shap", "bin_rows")
    before = [build.library_path(n) for n in names]
    monkeypatch.setattr(build, "EXTRA_FLAGS", {})
    after = [build.library_path(n) for n in names]
    assert after[0] != before[0] and after[1] == before[1]


def test_reciprocal_zero_fractions():
    """1 / z of every slot: +0.0 exactly where z is 0 (a leaf of count 0,
    a node of weight 0), elsewhere the correctly rounded 1 / z."""
    host, _ = tshap.shap_tables(shap_adversarial_trees(0), 1,
                                kts.MAX_DEPTH)
    z, rz = host.zfrac, host.rzfrac
    assert rz.dtype == np.float64 and rz.shape == z.shape
    zero = z == 0
    assert zero[host.feat >= 0].any()
    assert (rz[zero] == 0).all() and not np.signbit(rz[zero]).any()
    for zv, rv in zip(z[~zero], rz[~zero]):
        assert rv == float(1 / Fraction(zv))
        assert abs(rv - 1 / zv) <= np.spacing(abs(rv))


def _tables(trees, k, X):
    host, base = tshap.shap_tables(trees, k, tshap.device_depth(trees))
    tabs = kts.ShapTables(*(torch.as_tensor(a) for a in host))
    return torch.as_tensor(np.ascontiguousarray(X.T)), tabs, host, base


@pytest.mark.parametrize("k", [1, 3])
def test_plain_group_partials_equal_one_group(k):
    """The trees' sums added as the kernel adds them under plans of every
    group count (a tree a group, groups of 2 and of 3 trees, one group):
    each group's trees into their slices of a partial buffer, then the
    slices into their classes in tree order.  The same bytes as the plain
    version; within 1e-9 of each row's scale of the exact host walk."""
    trees = shap_adversarial_trees(0)
    X = shap_adversarial_rows(0, 150)
    X_T, tabs, host, base = _tables(trees, k, X)
    T, L, D = host.feat.shape
    F, n = X_T.shape
    one = kts.tree_shap_plain(X_T, tabs, k)
    plans = [kts.shap_plan(n, T, sm, F, L, D) for sm in (200, 4, 3, 1)]
    plans.append(kts.shap_plan(n, T, 200, F, L, D, partial_bytes=0))
    seen = set()
    for plan in plans:
        seen.add(plan.groups)
        per = plan.trees_per_group
        partial = torch.cat([kts.tree_sums_plain(X_T, tabs, g * per,
                                                 min(T, (g + 1) * per))
                             for g in range(plan.groups)])
        assert partial.shape == (T, n, F)
        phi = torch.zeros_like(one)
        for t, c in enumerate(host.tree_class.tolist()):
            phi[:, c, :F] += partial[t]
        assert torch.equal(phi, one)
    assert {1, T} <= seen and len(seen) >= 3
    got = one.numpy().copy()
    got[:, :, F] += base[None, :]
    exact = tshap.predict_contrib(trees, X, k).reshape(n, k, F + 1)
    scale = np.maximum(np.abs(exact).max(axis=(1, 2), keepdims=True), 1.0)
    assert (np.abs(got - exact) <= 1e-9 * scale).all()


def test_plain_against_jax_host_walk_on_a_trained_model():
    """A model trained by the port, loaded into the JAX package: the plain
    version within 1e-9 of each row's scale of the JAX package's exact
    host walk."""
    rs = np.random.RandomState(12)
    X = rs.randn(1500, 6)
    X[rs.rand(1500) < 0.1, 0] = np.nan
    X[rs.rand(1500) < 0.2, 2] = 0.0
    y = (X[:, 1] + np.nan_to_num(X[:, 0]) + 0.5 * X[:, 2] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 5, "zero_as_missing": True,
              "device_type": "cpu"}
    bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params)), 5)
    Xt = X[:300]
    want = lgb.Booster(model_str=bst.model_to_string()).predict(
        Xt, pred_contrib=True)
    X_T, tabs, host, base = _tables(bst._all_trees(), 1, Xt)
    got = kts.tree_shap_plain(X_T, tabs, 1)[:, 0].numpy().copy()
    got[:, -1] += base[0]
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(got - want) <= 1e-9 * scale).all()


def test_hot_slots_match_the_host_decisions():
    """hot_slots_plain (the kernel's one fractions) against the host walk's
    decisions: a slot is hot exactly where every occurrence of its feature
    on the leaf's path goes the row's way."""
    trees = shap_adversarial_trees(0)
    X = shap_adversarial_rows(0, 60)
    X_T, tabs, host, _ = _tables(trees, 1, X)
    multi = [t for t in trees if t.num_leaves > 1]
    for ti, t in enumerate(multi):
        hot = kts.hot_slots_plain(X_T, tabs, ti).numpy()
        dec = tshap._all_decisions(t, X)
        feat, _, on, ol, osl, plen = tshap._leaf_paths(t, kts.MAX_DEPTH)
        for leaf in range(t.num_leaves):
            for s in range(plen[leaf]):
                occ = [(on[leaf, r], ol[leaf, r]) for r in range(
                    kts.MAX_DEPTH) if on[leaf, r] >= 0 and osl[leaf, r] == s]
                want = np.all([dec[:, nd] == lf for nd, lf in occ], axis=0)
                np.testing.assert_array_equal(hot[:, leaf, s], want)
