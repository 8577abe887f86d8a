"""The counting functions against hand counts at small shapes."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

from benchmark import counts


def test_roofline_picks_the_binding_side():
    ms, what = counts.roofline(3.35e9, 0.0)
    assert ms == pytest.approx(1.0) and what == "bytes"
    ms, what = counts.roofline(0.0, 67e9)
    assert ms == pytest.approx(1.0) and what == "operations"
    assert counts.roofline(0.0, 1979e9, counts.INT8_OPS_PER_S)[0] == pytest.approx(1.0)


def test_window_pairs():
    assert [counts.window_pairs(w) for w in (3, 5, 7)] == [4, 12, 24]


def test_refine_work_by_hand():
    # one pixel, C=2, window 3 (P=4), one ncut step: affinities 11·4, S·logS 3·2,
    # softmaxes 2·8, KL 10, pairs 6·4·1, VJPs (13+4)·2, Adam 14·2
    nbytes, ops = counts.refine_work(1, 1, 1, 2, 3, 1, "ncut")
    assert ops == 44 + 6 + (16 + 10 + 24 + 34 + 28)
    assert nbytes == 4 * 2 + 12 + 4 + 1
    _, boundary = counts.refine_work(1, 1, 1, 2, 3, 1, "boundary")
    assert boundary == 44 + 6 + (8 + 10 + 24 + 26 + 28)


def test_bilateral_and_window_work_by_hand():
    nbytes, ops = counts.bilateral_work(2, 10, 4, 5, 2)
    assert ops == 2 * 10 * 4 * (15 + 4)
    assert nbytes == 4 * 2 * (50 + 20 + 8 + 20)
    nbytes, ops = counts.window_work(1, 2, 2, 2, 3, backward=False)
    assert ops == 4 * (44 + 3 * 4 * 2) and nbytes == 4 * 4 * 5


def test_cc_q1_q2_bytes():
    assert counts.cc_bound_ms(64, 256, 256) == pytest.approx(
        64 * 65536 * 5 / counts.HBM_BYTES_PER_S * 1e3)
    assert counts.q1_bytes(10, 32, 16) == 40 + 512
    assert counts.q2_bytes(2, 3, 4, 5, False) == 120 * 8
    assert counts.q2_bytes(2, 3, 4, 5, True) == 120 * 12


def test_conv_flops_counts_taps_inside_the_input():
    # 3x3, stride 1, padding 1 on 4x4: per axis the taps reach 3 + 4 + 3 outputs
    args = (1, 2, 3, (4, 4), (4, 4), (3, 3), (1, 1), (1, 1), (1, 1))
    assert counts.conv_flops(*args, backward=False) == 2.0 * 3 * 2 * 10 * 10
    assert counts.conv_flops(*args, backward=True) == 3 * 2.0 * 3 * 2 * 10 * 10
    # rate 4 on 4x4: only the centre tap reaches the map
    dil = (1, 2, 3, (4, 4), (4, 4), (3, 3), (1, 1), (4, 4), (4, 4))
    assert counts.conv_flops(*dil, backward=False) == 2.0 * 3 * 2 * 16


def test_conv_gflop_of_a_small_model():
    model = nn.Sequential(nn.Conv2d(3, 4, 1), nn.Conv2d(4, 2, 3, padding=1))
    x = torch.zeros(1, 3, 4, 4)
    first, second = 2.0 * 16 * 4 * 3, 2.0 * 2 * 4 * 10 * 10
    assert counts.conv_gflop(model, x) * 1e9 == pytest.approx(first + second)
    # training: the first convolution's input gradient is not needed
    assert counts.conv_gflop(model, x, backward=True) * 1e9 == pytest.approx(
        2 * first + 3 * second)
    assert counts.conv_gflop(model, x, within="1") * 1e9 == pytest.approx(second)


def test_times_part_flags_a_trace_and_events_that_disagree():
    assert not counts.times_part(2.0, 2.4)
    assert counts.times_part(4.65, 9.46)
    assert counts.times_part(9.46, 4.65)
    assert not counts.times_part(None, 9.46)
