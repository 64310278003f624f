"""Learning to rank on the card.

Marked ``cuda``: each test skips without a CUDA device.  Run on the card
with ``python -m pytest tests/test_torch_ranking_card.py``.  This file
imports no JAX.

- Lambdarank, XE-NDCG and position-bias gradients on the card against the
  port's on the CPU, under tests/test_torch_ranking.py's rules against the
  JAX package (``chip_smoke.ranking_gradients_card_vs_cpu``).
- ``fused_iter`` on against off on the card: byte-identical model text, the
  fused run through graph replays (position biases updated in place inside
  the head graph).
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_torch as lt

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lightgbm_torch.kernels import build
    build.build()


def test_gradients_on_the_card_match_the_cpu():
    _, y, sizes, pos = chip_smoke.make_ranking_small(6000, 0)
    # the function raises past its bounds; a first step's are the tightest
    diffs = chip_smoke.ranking_gradients_card_vs_cpu(y, sizes, pos, 0)
    assert max(v for k, v in diffs.items() if "step" not in k) <= 4e-6


def _text(bst):
    return "\n".join(line for line in bst.model_to_string().splitlines()
                     if not line.startswith("[fused_iter:"))


@pytest.mark.parametrize("arm", sorted(chip_smoke.RANK_SMALL_ARMS))
def test_fused_on_off_byte_identical_on_the_card(arm):
    X, y, sizes, pos = chip_smoke.make_ranking_small(6000, 1)
    extra = dict(chip_smoke.RANK_SMALL_ARMS[arm])
    position = pos if extra.pop("position", False) else None
    texts = []
    for fused in ("auto", "off"):
        p = {"objective": "lambdarank", "num_leaves": 31, "max_bin": 63,
             "min_data_in_leaf": 5, "verbosity": -1, **extra,
             "fused_iter": fused}
        bst = lt.train(p, lt.Dataset(X, label=y, group=sizes,
                                     position=position, params=p), 5)
        fuses = arm != "rank_xendcg" and fused == "auto"
        assert bst.engine._fused == fuses
        if fuses:
            assert bst.engine._graphs.replays > 0
        texts.append(_text(bst))
    assert texts[0] == texts[1]
