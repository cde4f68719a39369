"""``portbench/counts.py`` against numbers worked out by hand."""

import json
import os

import pytest

from portbench import counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    return json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       name + ".json")))


def test_k6_at_stablelms_old_train_shape():
    # (B, H, S, D) = (4, 32, 2048, 80), causal: 4*32*2048^2*160 FLOPs
    q = k = v = (4, 32, 2048, 80)
    flops, _ = counts.flash_attention_cost(q, k, v, True, "bfloat16")
    assert flops == 4 * 32 * 2048 ** 2 * 160 == pytest.approx(85.9e9,
                                                              rel=1e-3)
    bound = counts.flash_attention_bound(q, k, v, True, "bfloat16")
    assert bound == pytest.approx(0.0869e-3, rel=1e-3)


def test_k6_mla_shape_counts_both_head_dims():
    q, kv, v = (4, 16, 2048, 192), (4, 16, 2048, 192), (4, 16, 2048, 128)
    flops, nbytes = counts.flash_attention_cost(q, kv, v, True, "bfloat16")
    assert flops == 4 * 16 * 2048 ** 2 * (192 + 128)
    assert nbytes == 2 * (4 * 16 * 2048 * 192 * 2 + 4 * 16 * 2048 * 128 * 2)


def test_k2_bound():
    # 8192x2560 . 2560x6912, gate and up: 4*M*K*N FLOPs
    assert counts.fused_ff_bound((8192, 2560), (2560, 6912), "bfloat16") \
        == pytest.approx(0.5865e-3, rel=1e-3)
    flops, nbytes = counts.fused_ff_cost((8, 2560), (2560, 6912), "bfloat16")
    assert nbytes == 2 * (8 * 2560 + 2 * 2560 * 6912 + 8 * 6912)
    assert flops == 4 * 8 * 2560 * 6912


def test_n_active_stablelm():
    # 32 x (4 x 2560^2 + 3 x 2560 x 6912) + the head 2560 x 50304
    want = 32 * (4 * 2560 ** 2 + 3 * 2560 * 6912) + 2560 * 50304
    assert want == 2_666_332_160
    assert counts.n_active(config("stablelm3b")) == want


def test_n_active_deepseek_6_layers():
    mla = (2048 * 16 * 192 + 2048 * (512 + 64) + 512 * 16 * 128 * 2
           + 16 * 128 * 2048)
    dense = 3 * 2048 * 10944
    moe = 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    want = 6 * mla + dense + 5 * moe + 2048 * 102400
    assert want == 706_215_936
    assert counts.n_active(config("dsv2lite-6l")) == want


@pytest.mark.parametrize("name, seq, batch, tflop", [
    ("dsv2lite-6l", 4096, 2, 37.8), ("stablelm3b", 4096, 2, 147.5),
    ("dsv2lite-6l", 1024, 8, 35.5)])
def test_model_flops_of_a_step(name, seq, batch, tflop):
    assert counts.model_flops(config(name), seq, batch) / 1e12 == \
        pytest.approx(tflop, rel=2e-3)


def test_attention_share_of_the_1k_cell_is_a_quarter():
    c = config("dsv2lite-6l")
    assert counts.attention_flops(c, 1024, 8) * 4 == \
        counts.attention_flops(c, 4096, 2)
