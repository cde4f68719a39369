"""The deployed config chooses the CUDA tiling (ROADMAP C1, bf16): each
wrapper's pure ``select_tiling`` maps (dtype, shape, deployed keywords) to
a kernel instance compiled in its ``.cu``.  The ``.cu`` files cannot be
compiled here, so their tables of instances are read as text."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import bmm as bmm_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import matmul_leakyrelu as mlr_mod

CSRC = Path(fa_mod.__file__).resolve().parent / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


def _fa_shape(cfg):
    return (1, 4, 4 * cfg["bq"], cfg["d"])


def _gemm_shape(name, cfg):
    m, k, n = 2 * cfg["bm"], 2 * cfg["bk"], 2 * cfg["bn"]
    return (m, k, n) if name == "matmul_leakyrelu" else (3, m, k, n)


_MODS = {"flash_attention": fa_mod, "matmul_leakyrelu": mlr_mod,
         "bmm": bmm_mod}


def _select(name, dtype, cfg, **kw):
    mod = _MODS[name]
    shape = (_fa_shape(cfg) if name == "flash_attention"
             else _gemm_shape(name, cfg))
    return mod.select_tiling(dtype, shape, **cfg, **kw)


_CASES = [(name, cfg) for name, mod in _MODS.items() for cfg in mod.CONFIGS]


@pytest.mark.parametrize("name,cfg", _CASES,
                         ids=[f"{n}-{'-'.join(map(str, c.values()))}"
                              for n, c in _CASES])
def test_every_bf16_config_selects_its_own_wgmma_instance(name, cfg):
    tiling = _select(name, BF16, cfg)
    compiled = fa_mod.TILINGS if name == "flash_attention" \
        else mlr_mod.TILINGS      # K3 and K4 share csrc/gemm.cu
    assert tiling in compiled and tiling.startswith("wgmma_")
    for key, value in cfg.items():   # the instance is the config's
        tag = {"d": "_d", "bq": "_bq", "bk": "_bk", "bm": "_bm",
               "bn": "_bn"}[key]
        assert f"{tag}{value}_" in tiling + "_"


@pytest.mark.parametrize("name", sorted(_MODS))
def test_distinct_configs_select_distinct_instances(name):
    tilings = [_select(name, BF16, cfg) for cfg in _MODS[name].CONFIGS]
    assert len(set(tilings)) == len(tilings)


@pytest.mark.parametrize("name,cfg", _CASES,
                         ids=[f"{n}-{'-'.join(map(str, c.values()))}"
                              for n, c in _CASES])
def test_f32_and_unaligned_take_the_simt_instance(name, cfg):
    simt = fa_mod.SIMT if name == "flash_attention" else mlr_mod.SIMT
    assert _select(name, F32, cfg) == simt
    assert _select(name, BF16, cfg, aligned=False) == simt


@pytest.mark.parametrize("name,shape", [
    ("flash_attention", (2, 8, 1000, 20)),       # D % 8 != 0
    ("matmul_leakyrelu", (131, 77, 45)),         # K, N % 8 != 0
    ("matmul_leakyrelu", (128, 128, 45)),        # N % 8 != 0
    ("bmm", (2, 33, 17, 65)),
])
def test_rows_tma_cannot_take_go_to_simt_whatever_the_config(name, shape):
    """The ragged phase-2 shapes: the explicit dispatch on alignment,
    even at block sizes (1) with no wgmma instance."""
    mod = _MODS[name]
    cfg = ({} if name == "flash_attention"
           else {"bm": 1, "bn": 1, "bk": 1})
    want = fa_mod.SIMT if name == "flash_attention" else mlr_mod.SIMT
    assert mod.select_tiling(BF16, shape, **cfg) == want


@pytest.mark.parametrize("D,want", [(80, "wgmma_bq128_bk128_d80"),
                                    (32, "wgmma_bq128_bk128_d64"),
                                    (64, "wgmma_bq128_bk128_d64"),
                                    (128, "wgmma_bq128_bk128_d128")])
def test_flash_attention_default_tiling(D, want):
    """The training path's call names no bq / bk: the documented default
    (128 x 128), at the narrowest compiled head-dim width."""
    assert fa_mod.select_tiling(BF16, (4, 32, 2048, D)) == want


@pytest.mark.parametrize("name,shape,cfg", [
    ("flash_attention", (1, 4, 512, 64), {"bq": 64}),
    ("flash_attention", (1, 4, 512, 80), {"bq": 128, "bk": 256}),
    ("flash_attention", (1, 4, 512, 128), {"bq": 256, "bk": 128}),
    ("matmul_leakyrelu", (512, 512, 512), {"bm": 32, "bn": 128, "bk": 128}),
    ("matmul_leakyrelu", (512, 512, 512), {"bm": 256, "bn": 256, "bk": 64}),
    ("bmm", (2, 512, 512, 512), {"bm": 128, "bn": 64, "bk": 32}),
])
def test_a_bf16_config_with_no_instance_raises(name, shape, cfg):
    with pytest.raises(ValueError, match="compiled: simt"):
        _MODS[name].select_tiling(BF16, shape, **cfg)


def test_flash_attention_config_head_dim_must_match():
    with pytest.raises(ValueError):
        fa_mod.select_tiling(BF16, (1, 4, 512, 80), d=64)
    with pytest.raises(ValueError):
        fa_mod.select_tiling(BF16, (1, 4, 512, 160))


def _table(source):
    """The names of a .cu's kTilings table, in id order, and the template
    arguments each wgmma entry instantiates."""
    text = (CSRC / source).read_text()
    body = text[text.index("const Tiling kTilings[] = {"):]
    body = body[:body.index("};")]
    return re.findall(r'\{"(\w+)",\s*&([\w:]+)<([^>]*)>\}', body)


@pytest.mark.parametrize("source,names", [
    ("flash_attention.cu", fa_mod.TILINGS),
    ("gemm.cu", mlr_mod.TILINGS),
])
def test_the_cu_tables_list_the_wrappers_tilings_in_order(source, names):
    """The ids the wrappers pass through the C interface are positions in
    the .cu's table (the library's list is checked again at load)."""
    assert tuple(name for name, _, _ in _table(source)) == tuple(names)


_INSTANCES = ([("flash_attention.cu", n) for n in fa_mod.TILINGS]
              + [("gemm.cu", n) for n in mlr_mod.TILINGS])


@pytest.mark.parametrize("source,name", _INSTANCES,
                         ids=[n for _, n in _INSTANCES])
def test_each_instance_is_explicitly_instantiated(source, name):
    entry = {n: (fn, args) for n, fn, args in _table(source)}[name]
    fn, args = entry
    nums = [int(x) for x in re.findall(r"\d+", name)]
    if name.startswith("wgmma_"):
        assert fn == "launch_wgmma"
        assert [int(a) for a in args.split(",")] == nums
    else:
        assert fn.endswith("launch_simt") and args.strip() == "__nv_bfloat16"


def test_cpu_calls_launch_nothing_and_count_no_tiling():
    q = torch.randn(1, 4, 128, 64)
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    fa_mod.flash_attention(q, q, q, bq=128, bk=128, d=64)
    mlr_mod.matmul_leakyrelu(a, b)
    bmm_mod.bmm(a[None], b[None])
    for mod in _MODS.values():
        assert mod.launches == 0 and not mod.launches_by_tiling
