"""The roofline's copied arithmetic reproduces the bounds the port's
records give (``PERF.md``'s kernel table: K6 SW at the 64gb shape
1.201 ms, K1 0.188 ms)."""

import pytest

import tpualign_torch as tt
from benchmark import roofline
from tpualign_torch.ops import bitpal


def Scheme(match, mismatch, gap, local, **more):
    return dict(match=match, mismatch=mismatch, gap=gap, mode="local" if local else "global",
                **more)


SW = Scheme(2, -1, -2, True)
NW = Scheme(1, 0, -1, False)
PAIR = (126440, 127240)


def test_the_64gb_bounds():
    assert round(roofline.call_bound(SW, [PAIR]) * 1e3, 3) == 1.201
    assert round(roofline.call_bound(NW, [PAIR]) * 1e3, 3) == 0.188
    assert roofline.words_bound(*PAIR, 1)[1] == "operations"
    assert roofline.bound(*(0, 1))[1] == "operations" and roofline.bound(1, 0)[1] == "bytes"


def test_a_batch_bound():
    shapes = [(5000, 6000), (24000, 7000)]
    cells = sum(m * n for m, n in shapes)
    assert roofline.call_bound(SW, shapes) == 5 * cells / roofline.OPS_S
    assert roofline.call_bound(Scheme(2, -1, -2, False), shapes) == 4 * cells / roofline.OPS_S
    affine = Scheme(2, -1, -2, True, gap_open=-5, gap_extend=-2)
    assert roofline.call_bound(affine, shapes) == 10 * cells / roofline.OPS_S


def test_the_bit_parallel_family_takes_linear_schemes_only():
    assert roofline.family_g(NW) == 1
    assert roofline.family_g(Scheme(1, 0, -1, False, gap_open=-1, gap_extend=-1)) is None
    assert roofline.family_g(Scheme(1, 0, -1, False, matrix=[[1, 0], [0, 1]])) is None
    assert roofline.family_g(dict(NW, mode="semiglobal")) is None


@pytest.mark.parametrize("scheme", [(1, 0, -1), (1, 0, -2), (2, 0, -2), (2, -1, -2), (1, 0, -8),
                                    (3, 1, -2), (2, 1, -1), (1, -1, -1)])
def test_the_family_rule_is_the_programs(scheme):
    match, mismatch, gap = scheme
    mine = roofline.family_g(Scheme(match, mismatch, gap, False))
    theirs = bitpal.family(tt.ScoringConfig(match=match, mismatch=mismatch, gap=gap))
    assert mine == (None if theirs is None else theirs[1])
    assert roofline.family_g(Scheme(match, mismatch, gap, True)) is None
