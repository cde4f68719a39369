"""``portbench/counts.py`` against numbers worked out by hand."""

import json
import os
import sys
import types

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


@pytest.mark.parametrize("name, seq, batch, flops", [
    ("dsv2lite-6l", 4096, 2, 37804302139392.0),
    ("stablelm3b", 4096, 2, 147548232744960.0),
    ("dsv2lite-6l", 1024, 8, 35485019799552.0)])
def test_model_flops_of_the_cells_to_the_bit(name, seq, batch, flops):
    # the cells' numbers before model types could give attention_layers
    # and mixer_flops: neither module gives them, so none moves
    assert counts.model_flops(config(name), seq, batch) == flops


def test_attention_layers_and_mixer_flops_are_honoured(monkeypatch):
    # a hybrid of 10 layers, 1 of which attends, with 9 Mamba-2 mixers
    fam = types.ModuleType("portbench.reference.toyhybrid")
    fam.active_params = lambda c: 1000
    fam.attention_dims = lambda c: (32, 8, 128, 128)
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    c = {"model_type": "toyhybrid", "num_hidden_layers": 10}
    every = 10 * 6.0 * 2 * 32 * 4096 ** 2 * 256 / 2
    assert counts.attention_flops(c, 4096, 2) == every
    assert counts.mixer_flops(c, 4096, 2) == 0
    fam.attention_layers = lambda c: 1
    fam.mixer_flops = lambda c, seq, batch: 9 * counts.ssd_flops(
        batch, seq, 128, 64, 128)
    ssd = 9 * 12 * 2 * 4096 * 128 * 64 * 128
    assert counts.attention_flops(c, 4096, 2) == every / 10
    assert counts.mixer_flops(c, 4096, 2) == ssd
    assert counts.model_flops(c, 4096, 2) == \
        6.0 * 1000 * 4096 * 2 + every / 10 + ssd


@pytest.mark.parametrize("x, b, dtype, flops, ms", [
    # PERF.md's K7 rows: mamba2-1.3b's and zamba2-2.7b's train shapes
    ((4, 2048, 64, 64), (4, 2048, 1, 128), "bfloat16", 17179869184, 0.0419),
    ((4, 2048, 80, 64), (4, 2048, 2, 64), "bfloat16", 10737418240, 0.0521),
    ((4, 2048, 64, 64), (4, 2048, 1, 128), "float32", 17179869184, 0.2564)])
def test_k7_bounds(x, b, dtype, flops, ms):
    a = x[:3]
    got_flops, nbytes = counts.ssd_cost(x, a, b, dtype)
    assert got_flops == flops == 4 * x[0] * x[1] * x[2] * x[3] * b[3]
    size = counts.BYTES[dtype]
    assert nbytes == (2 * x[0] * x[1] * x[2] * x[3] * size
                      + 4 * x[0] * x[1] * x[2]
                      + 2 * b[0] * b[1] * b[2] * b[3] * size)
    assert counts.ssd_bound(x, a, b, dtype) * 1e3 == \
        pytest.approx(ms, abs=5e-5)
