"""counts.py against counts made by hand."""

import pytest

from portbench import counts


def test_k1_at_the_overthrust_grid():
    cells = 187 * 801 * 801
    assert cells == 119_979_387
    assert counts.k1_bytes(cells) == 16 * cells
    # bytes-bound: 1.9197e9 B at 3.35e12 B/s against 5.0392e9 flops at 67e12 flop/s
    assert counts.k1_least_s(cells) == pytest.approx(16 * cells / 3.35e12)
    assert counts.k1_least_s(cells) == pytest.approx(0.573e-3, rel=1e-3)
    assert 42 * cells / 67e12 == pytest.approx(0.0752e-3, rel=1e-3)


def test_whole_shot_step():
    cells = 187 * 801 * 801
    assert counts.shot_step_least_s(cells) == pytest.approx(20 * cells / 3.35e12)


def test_phi4_matmul_parameters_and_step_flops():
    # per layer: q 3072x3072, k and v 3072x1024, o 3072x3072, gate, up 3072x8192, down 8192x3072
    layer = 3072 * 3072 + 2 * 3072 * 1024 + 3072 * 3072 + 3 * 3072 * 8192
    assert layer == 100_663_296
    mm = counts.lm_matmul_params(3072, 24, 8, 128, 8192, 200_064, 16)
    assert mm == 16 * layer + 3072 * 200_064 == 2_225_209_344
    # 18 rows of 1024: 18 * 1024 * 1025 / 2 query-key pairs, 2 products of 2 flops x 128,
    # 24 heads, 16 layers
    attn = counts.causal_attention_flops(18, 1024, 24, 128, 16)
    assert attn == 4 * 18 * 524_800 * 24 * 128 * 16
    tokens = 9 * 2 * 1024
    assert counts.train_step_flops(mm, tokens, attn) == 6 * mm * tokens + 3 * attn
    # about 5.6% of 989 TFLOP/s over a 4.5 s step
    share = counts.train_step_flops(mm, tokens, attn) / (4.5 * counts.H100_BF16_FLOP_PER_S)
    assert 0.055 < share < 0.058


def test_paced_floor_matches_chip_smoke():
    # PR 22's chip log: 238.46 ms a microbatch, floor 2.385 s = 10.00 microbatches
    # (balanced 7.50, serial 10.00)
    assert counts.paced_floor_s(0.23846, 9, [1.0, 1.0, 4.0], 1.0) == pytest.approx(2.3846)
    assert counts.paced_floor_s(1.0, 9, [1.0, 1.0, 8.0], 4.0) == pytest.approx(
        9 / (2 / 5 + 1 / 33))
