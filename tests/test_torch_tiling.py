"""The deployed config chooses the CUDA tiling (ROADMAP C1; every kernel
in both types): each wrapper's pure ``select_tiling`` maps (dtype, shape,
deployed keywords) to a kernel instance compiled in its ``.cu``.  The
``.cu`` files cannot be compiled here, so their tables of instances are
read as text."""

import collections
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import bmm as bmm_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import fused_ff as ff_mod
from repro_torch.kernels import matmul_leakyrelu as mlr_mod
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import softmax as sm_mod
from repro_torch.kernels import ssd as ssd_mod

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


def _f32_instance(name, cfg):
    """The f32 SIMT instance a config names: K3/K4 the config's (bm, bn)
    with the K slab of 8, K6 the tile ``f32_block`` fits to it."""
    if name == "flash_attention":
        bq, bk = fa_mod.f32_block(cfg["bq"], cfg["bk"], cfg["d"])
        return f"simt_bq{bq}_bk{bk}_d{cfg['d']}"
    return f"simt_bm{cfg['bm']}_bn{cfg['bn']}_bk8"


@pytest.mark.parametrize("name,cfg", _CASES,
                         ids=[f"{n}-{'-'.join(map(str, c.values()))}"
                              for n, c in _CASES])
def test_f32_and_unaligned_take_the_simt_instance(name, cfg):
    """f32 takes the SIMT instance that the config names (C1 for the f32
    routes: one per block shape, compiled), bf16 with unaligned tensors
    the explicit SIMT instance of what TMA cannot take."""
    simt = fa_mod.SIMT if name == "flash_attention" else mlr_mod.SIMT
    compiled = fa_mod.TILINGS if name == "flash_attention" \
        else mlr_mod.TILINGS
    assert _select(name, F32, cfg) == _f32_instance(name, cfg) in compiled
    assert _select(name, BF16, cfg, aligned=False) == simt


@pytest.mark.parametrize("name", sorted(_MODS))
def test_two_f32_configs_select_distinct_simt_instances(name):
    """The C1 gate's f32 pairs: each kernel's CONFIGS hold entries that run
    different SIMT tiles in f32."""
    tilings = {_select(name, F32, cfg) for cfg in _MODS[name].CONFIGS}
    assert len(tilings) >= 2 and all(t.startswith("simt_") for t in tilings)


@pytest.mark.parametrize("cfg,want", [
    ({"bq": 128, "bk": 128, "d": 64}, (128, 128)),
    ({"bq": 128, "bk": 256, "d": 64}, (128, 128)),
    ({"bq": 256, "bk": 128, "d": 64}, (256, 64)),
    ({"bq": 128, "bk": 128, "d": 128}, (128, 64)),
])
def test_flash_attention_f32_tile_fits_a_block(cfg, want):
    """Configs whose f32 q, K^T, V and P tiles exceed 227 KB run a smaller
    tile named after it: bk halved first, then bq."""
    assert fa_mod.f32_block(cfg["bq"], cfg["bk"], cfg["d"]) == want
    bq, bk = want
    d = cfg["d"]
    assert 4 * (bq * (d + 4) + d * (bk + 1) + bk * d + bq * (bk + 4)) \
        <= 227 * 1024


def test_flash_attention_f32_model_calls_and_unknown_tiles():
    """The model's f32 calls name no bq / bk: the 64 x 64 SIMT kernel at
    any head dim; an f32 config with no compiled tile raises."""
    assert fa_mod.select_tiling(F32, (4, 32, 2048, 80)) == fa_mod.SIMT
    assert fa_mod.select_tiling(F32, (4, 32, 2048, 20)) == fa_mod.SIMT
    with pytest.raises(ValueError, match="compiled: simt"):
        fa_mod.select_tiling(F32, (1, 4, 512, 80), bq=128, bk=128)
    with pytest.raises(ValueError, match="compiled: simt"):
        mlr_mod.select_tiling(F32, (512, 512, 512), bm=32, bn=128, bk=128)


@pytest.mark.parametrize("name,shape", [
    ("matmul_leakyrelu", (131, 77, 45)),         # K, N % 4 != 0
    ("matmul_leakyrelu", (128, 128, 46)),        # N % 4 != 0
    ("bmm", (2, 33, 18, 65)),
])
def test_f32_rows_the_vector_loads_cannot_take_go_to_simt(name, shape):
    """f32 rows the 4-element loads cannot take keep the explicit SIMT
    instance they have, whatever the config."""
    assert _MODS[name].select_tiling(F32, shape, bm=1, bn=1, bk=1) \
        == mlr_mod.SIMT


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


@pytest.mark.parametrize("dtype,want", [(BF16, "wgmma_bq128_bk128_d192_v128"),
                                        (F32, "simt_bq64_bk64_d192_v128")])
def test_flash_attention_mla_head_dims_select_their_instance(dtype, want):
    """MLA's call (deepseek-v2-lite: q and k of 192 = 128 + 64 rope, v of
    128) names no bq / bk: the (D 192, Dv 128) instance of each type,
    the same for the default tile named explicitly in bf16."""
    shape = (4, 16, 2048, 192)
    assert fa_mod.select_tiling(dtype, shape, dv=128) == want
    assert want in fa_mod.TILINGS
    if dtype == BF16:
        assert fa_mod.select_tiling(dtype, shape, dv=128, bq=128, bk=128,
                                    d=192) == want


@pytest.mark.parametrize("dtype,shape,kw", [
    (BF16, (1, 4, 512, 192), {}),                      # Dv = D = 192
    (F32, (1, 4, 512, 192), {"dv": 192}),
    (BF16, (1, 4, 512, 256), {"dv": 128}),             # D past 192
    (BF16, (1, 4, 512, 192), {"dv": 160}),             # Dv past 128
    (BF16, (1, 4, 512, 192), {"dv": 128, "aligned": False}),
    (BF16, (1, 4, 512, 192), {"dv": 128, "bq": 256, "bk": 128}),
    (F32, (1, 4, 512, 192), {"dv": 128, "bq": 128, "bk": 128}),
])
def test_flash_attention_head_dims_with_no_instance_raise(dtype, shape, kw):
    """A (D, Dv) pair, or a tile at MLA's widths, that no instance holds
    raises, listing the instances; it never falls back."""
    with pytest.raises(ValueError, match="compiled: simt"):
        fa_mod.select_tiling(dtype, shape, **kw)


def _table(source):
    """The entries of a .cu's kTilings table, in id order: (name, [the
    launchers]), each launcher (function, its template arguments) or None
    (``nullptr``: the instance has no launcher of that type)."""
    text = (CSRC / source).read_text()
    body = text[text.index("const Tiling kTilings[] = {"):]
    body = body[:body.index("};")]
    out = []
    for name, rest in re.findall(r'\{"(\w+)",([^}]*)\}', body):
        fns = re.findall(r"(nullptr|&[\w:]+(?:<[^>]*>)?)", rest)
        out.append((name, [None if f == "nullptr" else
                           re.match(r"&([\w:]+)(?:<([^>]*)>)?", f).groups()
                           for f in fns]))
    return out


@pytest.mark.parametrize("source,names", [
    ("flash_attention.cu", fa_mod.TILINGS),
    ("flash_attention_bwd.cu", fa_mod.BACKWARD_TILINGS),
    ("gemm.cu", mlr_mod.TILINGS),
    ("rmsnorm.cu", rms_mod.TILINGS),
    ("fused_ff.cu", ff_mod.TILINGS),
    ("softmax.cu", sm_mod.TILINGS),
    ("ssd.cu", ssd_mod.TILINGS),
])
def test_the_cu_tables_list_the_wrappers_tilings_in_order(source, names):
    """The ids the wrappers pass through the C interface are positions in
    the .cu's table (the library's list is checked again at load)."""
    assert tuple(name for name, _ in _table(source)) == tuple(names)


def _args(args):
    return [a.strip() for a in args.split(",")] if args else []


_INSTANCES = ([("flash_attention.cu", n) for n in fa_mod.TILINGS]
              + [("gemm.cu", n) for n in mlr_mod.TILINGS])


@pytest.mark.parametrize("source,name", _INSTANCES,
                         ids=[n for _, n in _INSTANCES])
def test_each_instance_is_explicitly_instantiated(source, name):
    """Each name's launchers instantiate the tile the name says: wgmma
    instances in bf16 only, the per-config SIMT instances in f32 only,
    the explicit SIMT instance in both types."""
    f32, bf16 = dict(_table(source))[name]
    nums = [int(x) for x in re.findall(r"\d+", name)]
    if name.startswith("wgmma_"):
        assert f32 is None and bf16[0] == "launch_wgmma"
        assert [int(a) for a in _args(bf16[1])] == nums
    elif name in (fa_mod.SIMT, mlr_mod.SIMT):
        assert f32[0].endswith("launch_simt") \
            and bf16[0].endswith("launch_simt")
        assert _args(f32[1])[0] == "float" \
            and _args(bf16[1])[0] == "__nv_bfloat16"
        if source == "gemm.cu":     # the 128 x 128 tile of its name
            assert _args(f32[1])[1:] == _args(bf16[1])[1:] == ["128", "128"]
    else:                           # simt_bq*_bk*_d* / simt_bm*_bn*_bk8
        assert bf16 is None
        args = _args(f32[1])
        if source == "gemm.cu":
            assert f32[0] == "launch_simt_f32"
            assert [int(a) for a in args] + [8] == nums
        else:
            assert f32[0] == "simt::launch_dp" and args[0] == "float"
            assert [int(a) for a in args[1:]] == nums


# ---------------------------------------------------------------------------
# K6's backward kernel: one instance per bf16 width pair, else the plain one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,Dv,want", [
    (64, 64, "wgmma_bk128_bq64_d64"),          # whisper
    (80, 80, "wgmma_bk128_bq64_d80"),          # stablelm-3b, zamba2
    (128, 128, "wgmma_bk128_bq64_d128"),       # olmoe
    (192, 128, "wgmma_bk128_bq64_d192_v128"),  # deepseek-v2-lite's MLA
    (32, 32, "wgmma_bk128_bq64_d64"),          # the paper's d 32
])
def test_flash_attention_backward_selects_its_width_pair(D, Dv, want):
    """Each head-dim width pair the forward runs in bf16 has its backward
    instance, at the first pair that holds (D, Dv), as ``select_tiling``
    picks the forward's."""
    shape = (2, 32, 4096, D)
    assert fa_mod.select_backward_tiling(BF16, shape, dv=Dv) == want
    assert want in fa_mod.BACKWARD_TILINGS
    assert fa_mod.select_tiling(BF16, shape, dv=Dv).startswith("wgmma_")


@pytest.mark.parametrize("dtype,shape,kw", [
    (F32, (2, 32, 4096, 80), {}),                      # f32
    (F32, (2, 16, 4096, 192), {"dv": 128}),
    (BF16, (2, 32, 4096, 80), {"aligned": False}),     # unaligned
    (BF16, (2, 8, 1000, 20), {}),                      # D % 8 != 0
    (BF16, (2, 8, 1000, 64), {"dv": 60}),              # Dv % 8 != 0
])
def test_flash_attention_backward_what_tma_cannot_take_is_plain(dtype, shape,
                                                               kw):
    """f32 calls, and bf16 that TMA cannot take, name no backward instance:
    their gradient is the plain version's (an explicit dispatch on the
    dtype and the shape)."""
    assert fa_mod.select_backward_tiling(dtype, shape, **kw) is None


@pytest.mark.parametrize("name", fa_mod.BACKWARD_TILINGS)
def test_each_backward_instance_is_explicitly_instantiated(name):
    """The backward table's launcher of each name instantiates the (q/k,
    v) widths the name says (v the same as q/k where it names none)."""
    (launcher,) = dict(_table("flash_attention_bwd.cu"))[name]
    widths = [int(x) for x in re.findall(r"_[dv](\d+)", name)]
    assert launcher[0] == "launch_bwd"
    assert [int(a) for a in _args(launcher[1])] == widths
    assert re.fullmatch(r"wgmma_bk128_bq64_d\d+(_v\d+)?", name)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 1 << 30, 0), (False, 16, 8)])
def test_flash_attention_cpu_gradient_takes_the_plain_route(
        causal, window, q_offset, monkeypatch):
    """On CPU tensors the Function's forward writes no log-sum-exp and its
    backward is the plain version's: ``plain_backward_calls`` counts it,
    and no backward kernel launches."""
    monkeypatch.setattr(fa_mod, "plain_backward_calls", 0)
    monkeypatch.setattr(fa_mod, "backward_launches", 0)
    monkeypatch.setattr(fa_mod, "backward_launches_by_tiling",
                        collections.Counter())
    q, k, v = (torch.randn(1, h, 40, 16, requires_grad=True)
               for h in (4, 2, 2))
    out = fa_mod.FlashAttentionFunction.apply(q, k, v, causal, window,
                                              q_offset, None)
    assert len(out.grad_fn.saved_tensors) == 3   # q, k, v: no out, no lse
    dy = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dy)
    assert fa_mod.plain_backward_calls == 1
    assert fa_mod.backward_launches == 0
    assert not fa_mod.backward_launches_by_tiling
    assert fa_mod.launches == 0
    out2, lse = fa_mod.flash_attention_op(q, k, v, causal, window, q_offset,
                                          None)
    assert lse.numel() == 0
    torch.testing.assert_close(out2, out)
    assert all(g is not None and g.shape == t.shape
               for g, t in zip(got, (q, k, v)))
    # the kernel's wrapper takes no CPU tensors: it raises, never falls back
    with pytest.raises(ValueError, match="no backward instance"):
        fa_mod.flash_attention_grad(q, k, v, out2, lse, dy, causal=causal,
                                    window=window, q_offset=q_offset,
                                    scale=None)


@pytest.mark.parametrize("requires_grad", [True, False])
def test_flash_attention_op_writes_lse_only_for_a_gradient(requires_grad,
                                                           monkeypatch):
    """Every K6 forward is a call of the operator
    ``repro_torch::flash_attention``.  Where the backward kernel would take
    the call, the operator hands the kernel a log-sum-exp buffer only if
    q, k or v requires a gradient, and the Function then saves the
    output and that buffer.  Serving and evaluation pass none, and the
    kernel writes nothing extra."""
    seen = []

    def kernel(q, k, v, *, lse=None, **kw):
        seen.append(lse)
        return q.new_zeros(q.shape[:-1] + (v.shape[-1],))
    monkeypatch.setattr(fa_mod, "_backward_tiling",
                        lambda q, k, v: fa_mod.BACKWARD_TILINGS[0])
    monkeypatch.setattr(fa_mod, "flash_attention", kernel)
    q, k, v = (torch.randn(1, 2, 70, 16, requires_grad=requires_grad)
               for _ in range(3))
    with torch.set_grad_enabled(requires_grad):
        out = fa_mod.FlashAttentionFunction.apply(q, k, v, True, 1 << 30, 0,
                                                  None)
    (lse,) = seen
    if requires_grad:
        assert lse.dtype == torch.float32
        assert tuple(lse.shape) == (1, 2, 128)   # 70 rows padded to 64s
        assert len(out.grad_fn.saved_tensors) == 5
    else:
        assert lse is None and out.grad_fn is None


def test_cpu_calls_launch_nothing_and_count_no_tiling_k1_k2_k5():
    x, g = torch.randn(16, 64), torch.ones(64)
    w = torch.randn(64, 32)
    rms_mod.rmsnorm(x, g, br=8)
    ff_mod.fused_ff(x, w, w)
    ff_mod.fused_ff(x[:8], w, w)
    sm_mod.softmax(x, br=8)
    for mod in (rms_mod, ff_mod, sm_mod):
        assert mod.launches == 0 and not mod.launches_by_tiling


def test_cpu_calls_launch_nothing_and_count_no_tiling():
    q = torch.randn(1, 4, 128, 64)
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    fa_mod.flash_attention(q, q, q, bq=128, bk=128, d=64)
    mlr_mod.matmul_leakyrelu(a, b)
    bmm_mod.bmm(a[None], b[None])
    for mod in _MODS.values():
        assert mod.launches == 0 and not mod.launches_by_tiling


# ---------------------------------------------------------------------------
# K1 rmsnorm, K2 fused_ff, K5 softmax: the instance of every deployed config
# ---------------------------------------------------------------------------

def _rows_shape(cfg):
    return (3 * cfg["br"], cfg["cols"])


def _ff_shape(cfg):
    return (2 * cfg["bm"], 2 * cfg["bk"], 2 * cfg["bn"])


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("cfg", rms_mod.CONFIGS,
                         ids=[f"br{c['br']}-cols{c['cols']}"
                              for c in rms_mod.CONFIGS])
def test_every_rmsnorm_config_selects_its_br_instance(cfg, dtype):
    tiling = rms_mod.select_tiling(dtype, _rows_shape(cfg), **cfg)
    assert tiling == f"block_br{cfg['br']}" in rms_mod.TILINGS


@pytest.mark.parametrize("cols", [2560, 8192, 16384])
@pytest.mark.parametrize("br", rms_mod.BLOCK_BR)
def test_rmsnorm_br_instances_take_any_vector_width(br, cols):
    """A br instance sweeps its rows with the whole block, so it holds no
    row in registers and takes any width of whole 16-byte vectors."""
    for dtype in (BF16, F32):
        assert rms_mod.select_tiling(dtype, (2 * br, cols), br=br) \
            == f"block_br{br}"
        assert rms_mod.select_tiling(dtype, (2 * br, cols + 1), br=br) \
            == "scalar"


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("cfg", sm_mod.CONFIGS,
                         ids=[f"br{c['br']}-cols{c['cols']}"
                              for c in sm_mod.CONFIGS])
def test_every_softmax_config_selects_its_br_instance(cfg, dtype):
    assert sm_mod.select_tiling(dtype, _rows_shape(cfg), **cfg) \
        == f"block_br{cfg['br']}"


@pytest.mark.parametrize("cfg", ff_mod.CONFIGS,
                         ids=["-".join(map(str, c.values()))
                              for c in ff_mod.CONFIGS])
def test_every_fused_ff_config_selects_a_wgmma_instance(cfg):
    """No entry raises: the fleets may deploy any of them.  Each runs the
    instance of its own block shape, but (256, 128, 64), which runs the
    (128, 128, 64) instance (two 128-row tiles in turn)."""
    tiling = ff_mod.select_tiling(BF16, _ff_shape(cfg), **cfg)
    block = (cfg["bm"], cfg["bn"], cfg["bk"])
    bm, bn, bk = ff_mod.SHARED_BLOCKS.get(block, block)
    assert tiling == f"wgmma_bm{bm}_bn{bn}_bk{bk}" in ff_mod.TILINGS


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("name", ["rmsnorm", "softmax", "fused_ff"])
def test_distinct_configs_select_distinct_instances_k1_k2_k5(name, dtype):
    if name == "fused_ff":
        tilings = {tuple(c.values()): ff_mod.select_tiling(
            dtype, _ff_shape(c), **c) for c in ff_mod.CONFIGS}
        # the documented exception: (256, 128, 64) shares (128, 128, 64)'s
        assert tilings.pop((256, 128, 64)) == tilings[(128, 128, 64)]
        if dtype == F32:     # the SIMT instance is (bm, bn)'s: bk shares it
            assert tilings[(128, 128, 128)] == tilings[(128, 128, 64)] \
                != tilings[(64, 256, 64)]
            return
        assert len(set(tilings.values())) == len(tilings) == 3
        return
    mod = rms_mod if name == "rmsnorm" else sm_mod
    tilings = {}
    for c in mod.CONFIGS:
        tilings.setdefault(c["br"], set()).add(
            mod.select_tiling(dtype, _rows_shape(c), **c))
    # the instance is the br's: configs that differ only in their width
    # (K1's br 8 at 2048 and 4096 columns) share it, and distinct br
    # values select distinct instances
    assert all(len(t) == 1 for t in tilings.values())
    assert len(set.union(*tilings.values())) == len(tilings)
    assert len(tilings) == (3 if name == "rmsnorm" else 4)


@pytest.mark.parametrize("name,shape", [
    ("rmsnorm", (8, 2560)), ("rmsnorm", (8192, 4096)),
    ("softmax", (40960, 4096)),
    ("fused_ff", (8192, 2560, 6912)), ("fused_ff", (8, 2560, 6912)),
])
def test_unaligned_tensors_take_the_explicit_simt_instance(name, shape):
    mod = {"rmsnorm": rms_mod, "softmax": sm_mod, "fused_ff": ff_mod}[name]
    want = ff_mod.SIMT if name == "fused_ff" else "scalar"
    for dtype in (BF16, F32):
        assert mod.select_tiling(dtype, shape, aligned=False) == want


@pytest.mark.parametrize("name,shape,want", [
    ("rmsnorm", (13, 1001), "scalar"),          # not a multiple of 8 / 4
    ("rmsnorm", (3, 1004), "scalar"),           # f32: 1004 % 4 == 0 below
    ("softmax", (1000, 1001), "scalar"),
    ("fused_ff", (300, 2560, 777), ff_mod.SIMT),   # N % 8 != 0
    ("fused_ff", (300, 77, 776), ff_mod.SIMT),     # K % 8 != 0
    ("fused_ff", (8, 2560, 777), ff_mod.SIMT),     # a ragged decode row
])
def test_ragged_rows_take_the_explicit_simt_instance(name, shape, want):
    mod = {"rmsnorm": rms_mod, "softmax": sm_mod, "fused_ff": ff_mod}[name]
    assert mod.select_tiling(BF16, shape) == want
    if shape == (3, 1004):     # 1004 f32 columns are 251 vectors
        assert mod.select_tiling(F32, shape) == "block_row"
        assert mod.select_tiling(F32, shape, br=8) == "block_br8"


def test_fused_ff_f32_above_the_decode_threshold_runs_simt():
    """f32 above the threshold runs the SIMT instance of the config's
    (bm, bn) (C1), (256, 128, 64) that of (128, 128) as in bf16, and the
    model's call the default block's."""
    for cfg in ff_mod.CONFIGS:
        block = (cfg["bm"], cfg["bn"], cfg["bk"])
        bm, bn, _ = ff_mod.SHARED_BLOCKS.get(block, block)
        assert ff_mod.select_tiling(F32, _ff_shape(cfg), **cfg) \
            == f"simt_bm{bm}_bn{bn}_bk8" in ff_mod.TILINGS
    assert ff_mod.select_tiling(F32, (8192, 2560, 6912)) \
        == "simt_bm{}_bn{}_bk8".format(*ff_mod.DEFAULT_BLOCK[:2])
    # rows the 4-element loads cannot take keep the explicit instance
    assert ff_mod.select_tiling(F32, (300, 2560, 778)) == ff_mod.SIMT


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("m,want", [(1, "gemv_m1"), (2, "gemv_m2"),
                                    (3, "gemv_m4"), (4, "gemv_m4"),
                                    (5, "gemv_m8"), (8, "gemv_m8")])
def test_fused_ff_decode_threshold_picks_gemv(m, want, dtype):
    """M at or below the threshold runs the split-K decode route in either
    type, whatever block sizes a config names; M one above it does not."""
    assert ff_mod.DECODE_ROWS == 8
    for cfg in [{}] + ff_mod.CONFIGS:
        assert ff_mod.select_tiling(dtype, (m, 2560, 6912), **cfg) == want
    above = ff_mod.select_tiling(dtype, (ff_mod.DECODE_ROWS + 1, 2560, 6912))
    assert above == (
        "simt_bm{}_bn{}_bk8".format(*ff_mod.DEFAULT_BLOCK[:2]) if dtype == F32
        else "wgmma_bm{}_bn{}_bk{}".format(*ff_mod.DEFAULT_BLOCK))


def test_model_calls_take_the_documented_defaults():
    """The model paths call with no config: K2 the default block, K1 and
    K5 a block a row."""
    assert ff_mod.select_tiling(BF16, (8192, 2560, 6912)) \
        == "wgmma_bm{}_bn{}_bk{}".format(*ff_mod.DEFAULT_BLOCK)
    for shape in ((8, 2560), (8192, 2560), (8192, 4096), (4, 8192)):
        for dtype in (BF16, F32):
            assert rms_mod.select_tiling(dtype, shape) == "block_row"
    # a deployed br at those widths: the instance of br rows a block, at
    # any width; br 1 is a block a row
    assert rms_mod.select_tiling(BF16, (8192, 2560), br=8) == "block_br8"
    assert rms_mod.select_tiling(F32, (8192, 2560), br=16) == "block_br16"
    assert rms_mod.select_tiling(BF16, (32, 8192), br=32) == "block_br32"
    assert rms_mod.select_tiling(F32, (32, 16384), br=32) == "block_br32"
    assert rms_mod.select_tiling(BF16, (8, 2560), br=1) == "block_row"
    assert sm_mod.select_tiling(BF16, (40960, 4096)) == "block_br1"


# the model's narrow K1 rows: olmoe-1b-7b's q/k norms (head dim 128) in
# training (B 4 x S 2048 x 16 heads), in the GSPMD step (4 heads a rank)
# and at decode (8 lanes x 16 heads); deepseek-v2-lite-16b's MLA latent
# norm (512) in training and at decode
_NARROW_PATHS = [((131072, 128), "lanes16_vec1", "lanes32_vec1"),
                 ((32768, 128), "lanes16_vec1", "lanes32_vec1"),
                 ((8192, 512), "lanes32_vec2", "lanes32_vec4"),
                 ((128, 128), "lanes16_vec1", "lanes32_vec1"),
                 ((8, 512), "lanes32_vec2", "lanes32_vec4")]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape,bf16,f32", _NARROW_PATHS,
                         ids=[f"{r}x{c}" for (r, c), _, _ in _NARROW_PATHS])
def test_rmsnorm_narrow_path_shapes_select_the_narrow_instances(
        shape, bf16, f32, dtype):
    """A call naming no br on a row of at most NARROW_ROW_BYTES runs the
    smallest narrow instance that holds the row; one vector wider runs
    block_row; a deployed br keeps its instance at the narrow widths;
    unaligned or ragged narrow rows keep scalar."""
    want = bf16 if dtype == BF16 else f32
    assert rms_mod.select_tiling(dtype, shape) == want in rms_mod.TILINGS
    assert rms_mod.narrow_tiling(dtype, shape[1]) == want
    rows, cols = shape
    vec = 16 // dtype.itemsize
    widest = rms_mod.NARROW_ROW_BYTES // dtype.itemsize
    assert rms_mod.select_tiling(dtype, (rows, widest)) \
        in rms_mod.NARROW_TILINGS
    assert rms_mod.select_tiling(dtype, (rows, widest + vec)) == "block_row"
    assert rms_mod.select_tiling(dtype, (8, 128), br=8) == "block_br8"
    if rows % 8 == 0:
        assert rms_mod.select_tiling(dtype, shape, br=8) == "block_br8"
    assert rms_mod.select_tiling(dtype, shape, aligned=False) == "scalar"
    assert rms_mod.select_tiling(dtype, (rows, cols + 1)) == "scalar"
    assert rms_mod.select_tiling(dtype, (rows, cols - 1)) == "scalar"


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("lanes,vec", rms_mod.NARROW)
def test_rmsnorm_narrow_rows_take_the_smallest_instance_that_holds_them(
        lanes, vec, dtype):
    """A row of exactly L x R vectors takes lanesL_vecR, a row of fewer
    (down to one more than the next smaller instance holds) too, and one
    vector more the next instance (block_row past the widest)."""
    per_vec = 16 // dtype.itemsize
    i = rms_mod.NARROW.index((lanes, vec))
    name = f"lanes{lanes}_vec{vec}"
    smaller = rms_mod.NARROW[i - 1][0] * rms_mod.NARROW[i - 1][1] if i else 0
    for nvec in (lanes * vec, smaller + 1):
        assert rms_mod.narrow_tiling(dtype, nvec * per_vec) == name
    above = rms_mod.narrow_tiling(dtype, (lanes * vec + 1) * per_vec)
    assert above == (rms_mod.NARROW_TILINGS[i + 1]
                     if i + 1 < len(rms_mod.NARROW) else None)


@pytest.mark.parametrize("name,shape,cfg", [
    ("rmsnorm", (64, 2048), {"br": 4}),
    ("rmsnorm", (64, 2048), {"br": 64}),
    ("softmax", (64, 2048), {"br": 2}),
    ("fused_ff", (512, 512, 512), {"bm": 32, "bn": 128, "bk": 128}),
    ("fused_ff", (512, 512, 512), {"bm": 128, "bn": 256, "bk": 64}),
])
def test_a_config_with_no_instance_raises_k1_k2_k5(name, shape, cfg):
    mod = {"rmsnorm": rms_mod, "softmax": sm_mod, "fused_ff": ff_mod}[name]
    with pytest.raises(ValueError, match="compiled: "):
        mod.select_tiling(BF16, shape, **cfg)


def test_gemv_splits_fill_the_card():
    """The workspace's upper limit on the slices of K: 10 at the decode
    shape on 132 SMs (540 blocks, about four an SM; the launcher takes
    the smaller of this and one wave of the card, 9 slices there); a
    short K is not cut below 64 rows a slice."""
    splits = ff_mod.gemv_splits(2560, 6912, BF16, 132)
    blocks = -(-6912 // 128) * splits
    assert (splits, blocks) == (10, 540)
    assert ff_mod.gemv_splits(2560, 6912, F32, 132) == 5
    assert ff_mod.gemv_splits(100, 6912, BF16, 132) == 2
    assert ff_mod.gemv_splits(0, 64, BF16, 132) == 1


_NEW_INSTANCES = ([("rmsnorm.cu", n) for n in rms_mod.TILINGS]
                  + [("fused_ff.cu", n) for n in ff_mod.TILINGS]
                  + [("softmax.cu", n) for n in sm_mod.TILINGS])


@pytest.mark.parametrize("source,name", _NEW_INSTANCES,
                         ids=[f"{s[:-3]}-{n}" for s, n in _NEW_INSTANCES])
def test_each_k1_k2_k5_instance_is_explicitly_instantiated(source, name):
    (fn, args), = dict(_table(source))[name]
    nums = [int(x) for x in re.findall(r"\d+", name)]
    args = _args(args)
    if name.startswith("wgmma_"):
        assert (fn, [int(a) for a in args]) == ("launch_wgmma", nums)
    elif name.startswith("gemv_m"):
        assert (fn, [int(a) for a in args]) == ("launch_gemv", nums)
    elif name.startswith("block_br"):
        assert (fn, args) == ("launch", ["true", str(nums[0])])
    elif name.startswith("lanes"):     # lanesL_vecR: L lanes, R vectors
        assert (fn, [int(a) for a in args]) == ("launch_narrow", nums)
    elif name == "block_row":
        assert (fn, args) == ("launch", ["true", "1"])
    elif source in ("softmax.cu", "rmsnorm.cu"):
        assert (name, fn, args) == ("scalar", "launch", ["false", "1"])
    elif name.startswith("simt_bm"):
        assert fn == "launch_simt_block"
        assert [int(a) for a in args] + [8] == nums
    else:
        assert (name, fn, args) == (ff_mod.SIMT, "launch_simt", [])


# ---------------------------------------------------------------------------
# K7 ssd: the deployed chunk chooses the instance
# ---------------------------------------------------------------------------

_SSM = (4, 2048, 64, 1, 64, 128)     # mamba2-1.3b's training shape


def _ssd_shape(cfg):
    return (2, 4 * cfg["chunk"], 4, 1, cfg["p"], cfg["n"])


@pytest.mark.parametrize("cfg", ssd_mod.CONFIGS,
                         ids=["-".join(map(str, c.values()))
                              for c in ssd_mod.CONFIGS])
def test_every_ssd_config_selects_its_own_wgmma_instance(cfg):
    tiling = ssd_mod.select_tiling(BF16, _ssd_shape(cfg), **cfg)
    assert tiling == "wgmma_l{chunk}_p{p}_n{n}".format(**cfg) \
        in ssd_mod.TILINGS


def test_ssd_chunk_64_and_128_select_distinct_instances():
    tilings = {c: ssd_mod.select_tiling(BF16, _SSM, chunk=c)
               for c in (64, 128)}
    assert tilings == {64: "wgmma_l64_p64_n128", 128: "wgmma_l128_p64_n128"}
    assert len({ssd_mod.select_tiling(BF16, _ssd_shape(c), **c)
                for c in ssd_mod.CONFIGS}) == len(ssd_mod.CONFIGS)


@pytest.mark.parametrize("shape,cfg", [
    (_SSM, {"chunk": 256}),
    (_SSM, {"chunk": 96}),
    (_SSM, {"chunk": 48}),
    ((2, 512, 4, 1, 128, 64), {"chunk": 128, "p": 128, "n": 64}),
    ((2, 512, 4, 1, 128, 128), {"chunk": 64}),
])
def test_an_ssd_config_with_no_instance_raises(shape, cfg):
    with pytest.raises(ValueError, match="compiled: simt_l64"):
        ssd_mod.select_tiling(BF16, shape, **cfg)


def test_ssd_model_calls_take_the_documented_default():
    """The model's calls (nn/ssm.py through ops.ssd_chunk) name no chunk
    but the default, 64: the (64, 64, 128) instance at mamba2's widths."""
    assert ssd_mod.DEFAULT_CHUNK == 64
    assert ssd_mod.select_tiling(BF16, _SSM) == "wgmma_l64_p64_n128"
    assert ssd_mod.select_tiling(BF16, _SSM, chunk=ssd_mod.DEFAULT_CHUNK) \
        == "wgmma_l64_p64_n128"


@pytest.mark.parametrize("shape,kw,want", [
    ((2, 1000, 8, 2, 64, 64), {}, "wgmma_l64_p64_n128"),    # N 64 padded
    ((2, 128, 1, 1, 32, 16), {"chunk": 32}, "wgmma_l64_p64_n128"),
    ((2, 1024, 16, 1, 128, 64), {}, "wgmma_l64_p128_n64"),
    ((2, 1000, 8, 2, 60, 50), {}, "simt_l64"),              # P, N % 8
    ((2, 1000, 8, 2, 64, 50), {"chunk": 128}, "simt_l64"),
    (_SSM, {"aligned": False}, "simt_l64"),
    (_SSM, {"chunk": 128, "aligned": False}, "simt_l64"),
    (_SSM, {"chunk": 256, "aligned": False}, "simt_l64"),
])
def test_ssd_shapes_wgmma_cannot_take_go_to_the_simt_instance(shape, kw,
                                                              want):
    """Widths the wgmma instances zero-pad run the first instance that
    holds them; rows the 16-byte copies cannot take run the named SIMT
    instance, chunk 64, whatever chunk the call names; a chunk that
    divides 64 runs the 64-position instance."""
    assert ssd_mod.select_tiling(BF16, shape, **kw) == want


@pytest.mark.parametrize("cfg", [{}] + ssd_mod.CONFIGS
                         + [{"chunk": 256}, {"chunk": 96}, {"chunk": 7}])
def test_ssd_f32_runs_the_simt_instance_in_chunks_of_64(cfg):
    """f32 runs the SIMT kernel in chunks of 64 whatever chunk the call
    names, also chunks (mamba2's upstream 256) that have no bf16
    instance."""
    shape = _ssd_shape(cfg) if "p" in cfg else _SSM
    assert ssd_mod.select_tiling(F32, shape, **cfg) == ssd_mod.SIMT \
        == "simt_l64"


def test_ssd_config_widths_must_be_the_operands():
    with pytest.raises(ValueError):
        ssd_mod.select_tiling(BF16, _SSM, chunk=64, p=128, n=64)
    with pytest.raises(ValueError):
        ssd_mod.select_tiling(BF16, (1, 64, 1, 1, 160, 64))


def test_ssd_cu_instances_are_explicitly_instantiated():
    """Each K7 tiling names its launcher and the query of its outputs
    kernel's resident blocks (which sizes the segments), both of the
    instance its name describes."""
    for name, launchers in _table("ssd.cu"):
        (fn, args), (slots_fn, slots_args) = launchers
        if name == ssd_mod.SIMT:
            assert (fn, args) == ("launch_simt", None)
            assert (slots_fn, slots_args) == ("simt_slots", None)
        else:
            assert (fn, slots_fn) == ("launch_wgmma", "wgmma_slots")
            assert [int(a) for a in _args(args)] \
                == [int(a) for a in _args(slots_args)] \
                == [int(x) for x in re.findall(r"\d+", name)]


def test_cpu_ssd_calls_launch_nothing_and_count_no_tiling():
    x, a = torch.randn(2, 128, 32), -torch.rand(2, 128)
    b = torch.randn(2, 128, 16)
    ssd_mod.ssd(x, a, b, b, chunk=64, p=32, n=16)
    ssd_mod.ssd_chunk(x[:, :, None], a[:, :, None], b[:, :, None],
                      b[:, :, None], chunk=128)
    assert ssd_mod.launches == 0 and not ssd_mod.launches_by_tiling
