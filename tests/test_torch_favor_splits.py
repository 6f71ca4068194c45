"""The FAVOR kernel's split rule (``ops/favor_cuda._splits``).

The accumulate pass of ``csrc/favor.cu`` sums each split's rows of ctx and
ksum in one float32 chain, whose rounding grows with its length. The rule
fills the card and never lets a split sum more than ``_SPLIT_TILES`` tiles,
whatever the batch (on the card, ``tools/favor_split_precision.py`` shows
what a longer chain costs). The card's SM count is stubbed: an H100's 132.
"""

import types

import pytest
import torch

from gridnext_tpu_torch.ops import favor_cuda

H, M, D = 10, 266, 64         # scBERT's heads, features and head width


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))


@pytest.mark.parametrize("n", [45, 1000, 16907])
@pytest.mark.parametrize("b", [1, 4, 8, 64, 256])
def test_no_split_sums_more_than_the_cap(h100, b, n):
    tiles = -(-n // favor_cuda._ROWS)
    splits = favor_cuda._splits(b * H, n, M, D, None)
    assert 1 <= splits <= tiles
    assert -(-tiles // splits) <= favor_cuda._SPLIT_TILES


def test_the_rule_still_fills_the_card(h100):
    # one (b, h): the fill wants more blocks than the cap needs
    fill = -(-favor_cuda._BLOCKS_PER_SM * 132 // (-(-(-(-M // 16)) // 6) * 1))
    assert favor_cuda._splits(1, 16907, M, D, None) == min(529, fill)
    # B 64 and B 256: the fill wants 2 and 1 splits, the cap 17 (529 tiles)
    assert favor_cuda._splits(64 * H, 16907, M, D, None) == 17
    assert favor_cuda._splits(256 * H, 16907, M, D, None) == 17
