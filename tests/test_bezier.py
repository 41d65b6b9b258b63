"""Bezier evaluation vs an independent numpy oracle of Bezier.fxh semantics."""

import math

import numpy as np
import pytest

from illuminant.ops import bezier as bz


def oracle_t(min_value, max_value, mode, value):
    """Independent reimplementation of tForScaledBezier (Bezier.fxh:21-63)."""
    divisor = max_value - min_value
    inv = 1.0 / divisor if divisor != 0 else 1.0
    repeating = mode > 255
    bouncing = mode > 511
    t = (value - min_value) * abs(inv)
    if bouncing:
        t *= 2
        t = 2 - math.fmod(t, 2) if inv < 0 else math.fmod(t, 2)
        if t > 1:
            t = 1 - (t - 1)
    elif repeating:
        t = 1 - math.fmod(t, 1) if inv < 0 else math.fmod(t, 1)
    else:
        t = min(max(t, 0.0), 1.0)
        if inv < 0:
            t = 1 - t
    base = mode % 256
    if base == 1:
        t = math.sin(t * math.pi * 0.5)
    elif base == 2:
        t = t * t
    return t


def oracle_eval(points, min_value, max_value, mode, value):
    t = oracle_t(min_value, max_value, mode, value)
    pts = [np.asarray(p, np.float64) for p in points]
    count = len(pts)
    a = pts[0]
    if count <= 1:
        return a
    b = pts[1]
    ab = a + (b - a) * t
    if count == 2:
        return ab
    c = pts[2]
    if count == 3:  # shelf
        if t <= 0:
            return a
        if t >= 1:
            return c
        return b
    d = pts[3]
    bc = b + (c - b) * t
    cd = c + (d - c) * t
    abbc = ab + (bc - ab) * t
    bccd = bc + (cd - bc) * t
    return abbc + (bccd - abbc) * t


CASES = [
    # (points, min, max, mode)
    ([[3.0]], 0.0, 1.0, 0),
    ([[1.0, 2.0], [5.0, -1.0]], 0.0, 2.0, 0),
    ([[0.0], [1.0], [0.5]], 0.0, 1.0, 0),  # shelf
    ([[0.0], [1.0], [0.0], [1.0]], 0.0, 4.0, 0),  # cubic
    ([[0.0], [1.0], [0.0], [1.0]], 1.0, 3.0, bz.MODE_SINE),
    ([[0.0], [1.0], [0.0], [1.0]], 0.0, 2.0, bz.MODE_EXP),
    ([[0.0], [2.0]], 0.0, 1.0, bz.MODE_LOOP_BIT),  # repeating
    ([[0.0], [2.0]], 0.0, 1.0, bz.MODE_BOUNCE_BIT + bz.MODE_LOOP_BIT),
    ([[0.0, 1.0, 2.0, 3.0], [4.0, 3.0, 2.0, 1.0]], 0.0, 1.0, 0),  # 4-channel
]

VALUES = [-0.7, 0.0, 0.1, 0.5, 0.99, 1.0, 1.3, 2.7, 5.0]


@pytest.mark.parametrize("case_idx", range(len(CASES)))
def test_matches_oracle(case_idx):
    points, lo, hi, mode = CASES[case_idx]
    packed = bz.pack_bezier(points, lo, hi, mode)
    got = np.asarray(bz.evaluate_bezier(packed, np.asarray(VALUES, np.float32)))
    for i, v in enumerate(VALUES):
        want = oracle_eval(points, lo, hi, mode, v)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"value={v}")


def test_constant_bezier():
    packed = bz.constant_bezier([1.0, 2.0, 3.0, 4.0])
    out = np.asarray(bz.evaluate_bezier(packed, np.linspace(-5, 5, 7)))
    assert out.shape == (7, 4)
    np.testing.assert_allclose(out, np.tile([1, 2, 3, 4], (7, 1)))


def test_reversed_time():
    # max < min -> negative inv_divisor reverses t (Bezier.fxh:44-49).
    packed = bz.pack_bezier([[0.0], [10.0]], 1.0, 0.0, 0)
    out = np.asarray(
        bz.evaluate_bezier(packed, np.asarray([0.0, 0.5, 1.0, 2.0]))
    )
    # min=1, max=0 -> inv_divisor=-1 (reversed). t_raw=(v-1)*|inv|,
    # clamped then flipped: v=0 -> 1-0=1 -> 10; v=0.5 -> 1-0=1 -> 10
    # (raw -0.5 clamps to 0); v=1 -> 1-0=1 -> 10; v=2 -> 1-1=0 -> 0.
    np.testing.assert_allclose(out[:, 0], [10.0, 10.0, 10.0, 0.0], atol=1e-5)


def test_batch_shape():
    packed = bz.pack_bezier([[0.0], [1.0]], 0.0, 1.0, 0)
    out = bz.evaluate_bezier(packed, np.zeros((3, 5), np.float32))
    assert out.shape == (3, 5, 1)
