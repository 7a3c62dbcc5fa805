"""The operations and bytes the yardstick counts, against hand-worked
values."""
import pytest

from bench import roofline as R


def test_knn_topk_cost():
    f, b = R.knn_topk_cost(1024, 1_000_000, 768, 100)
    assert f == 2 * 1024 * 1_000_000 * 768 == 1.572864e12
    assert b == 1_000_000 * 768 * 4 + 1024 * 768 * 4 + 1024 * 100 * 8
    t, by = R.bound(b, f, "float32")
    assert by == "operations" and t == pytest.approx(1.572864e12 * 3
                                                     / 494.7e12)
    t, by = R.bound(*reversed(R.knn_topk_cost(64, 1_000_000, 768, 100)),
                    "float32")
    assert by == "bytes" and t == pytest.approx(3.0737e9 / 3.35e12,
                                                rel=1e-3)


def test_attended_pairs():
    assert R.attended_pairs(4, 4, True) == 10
    assert R.attended_pairs(4, 4, True, window=2) == 1 + 2 + 2 + 2
    assert R.attended_pairs(3, 5, False) == 15
    assert R.attended_pairs(4096, 4096, True, 4096) == 4096 * 4097 // 2


def test_flash_costs_at_the_danube_step():
    # 2 x 4,096, 32 / 8 heads of 80, bf16, causal: 8,390,656 kept pairs
    f, b = R.flash_fwd_cost(2, 4096, 4096, 32, 8, 80, 2, True, 4096)
    assert f == 4 * 2 * 32 * 80 * 8_390_656
    assert b == 2 * 2 * 80 * (2 * 4096 * 32 + 2 * 4096 * 8) + 4 * 2 * 32 * 4096
    assert R.bound(b, f, "bfloat16")[0] * 1e3 == pytest.approx(0.1738,
                                                               abs=1e-4)
    f2, _ = R.flash_bwd_cost(2, 4096, 4096, 32, 8, 80, 2, True, 4096)
    assert f2 == 2.5 * f
    assert f2 / 989e12 * 1e3 == pytest.approx(0.4344, abs=1e-4)


def test_encoder_flops():
    # per text: 2 layers x (2 x 64 x (4 x 768^2 + 3 x 768 x 1536)
    #   + 4 x 12 x 64 x 2,080 kept pairs)
    per = 2 * (2 * 64 * (4 * 768 * 768 + 3 * 768 * 1536)
               + 4 * 12 * 64 * 2080)
    assert per == 1_522_728_960
    assert R.encoder_flops(1024, 64, 2, 768, 12, 64, 1536) == 1024 * per


def test_danube_step_flops():
    blk = 2560 * 2560 * 2 + 2560 * 640 * 2 + 3 * 2560 * 6912
    assert blk == 69_468_160
    weights = 24 * blk + 2560 * 32000
    attn = 24 * 12 * 2 * 32 * 80 * 8_390_656
    f = R.lm_train_flops(2, 4096, 24, 2560, 32, 8, 80, 6912, 32000, 4096)
    assert f == 6 * weights * 8192 + attn
    assert f == pytest.approx(9.8347e13, rel=1e-4)
