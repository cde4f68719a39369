"""The port's kernel modules on the CPU: the plain versions of ``rmsnorm``,
``fused_ff``, ``flash_attention``, ``matmul_leakyrelu``, ``bmm`` and
``softmax`` against
the JAX package's Pallas kernels (interpret mode) and its jnp oracles, on
the same seeded numpy inputs; the gradients of the model kernels'
``autograd.Function``s against JAX's gradients of the same oracles; and
the wrappers' dispatch rules (a CPU tensor takes the plain version and
launches nothing; anything else launches the kernel or raises); and every
registered kernel, ``ssd`` included, called as a deployed config calls it
(``ssd``'s parity tests are in ``tests/test_torch_ssm.py``).

Tolerances are those of ``tests/test_kernels.py`` for the same kernels:
f32 atol 2e-5 (rmsnorm, matmul_leakyrelu, bmm) / 1e-4 (fused_ff, 128-term
dot products summed in another order) / 2e-4 (flash_attention), bf16 atol
2e-2 / 5e-2 / 3e-2 (one bf16 rounding of the output, plus bf16 operands),
rtol 2e-2 / 3e-2; softmax f32 atol 2e-6 (``test_softmax_paper_config``),
bf16 one bf16 rounding of the output (rtol 2^-7).
Gradients are f32 against f32 at atol 1e-5 to 1e-4 (sums of up to 96
terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bmm import bmm as pallas_bmm
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash_attention
from repro.kernels.fused_ff import fused_ff as pallas_fused_ff
from repro.kernels.matmul_leakyrelu import \
    matmul_leakyrelu as pallas_matmul_leakyrelu
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.softmax import softmax as pallas_softmax
from repro_torch.kernels import KERNELS
from repro_torch.kernels import bmm as bmm_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import fused_ff as ff_mod
from repro_torch.kernels import matmul_leakyrelu as mlr_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import softmax as sm_mod
from repro_torch.kernels import ssd as ssd_mod

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RMS_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
FF_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(a, dtype):
    """The same numpy array in both frameworks, rounded to ``dtype`` the
    same way (round to nearest even) on both sides."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_and_oracle(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 2048)) * 0.5).astype(np.float32)
    g = (rng.standard_normal(2048) * 0.5 + 1.0).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    got = rms_mod.rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (pallas_rmsnorm(jx, jg, br=8, interpret=True),
                 jref.rmsnorm(jx, jg)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=RMS_ATOL[dtype], rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(256, 128), (64, 512)])
def test_rmsnorm_narrow_rows_match_pallas_and_oracle(dtype, rows, cols):
    """The narrow rows the model normalises (olmoe-1b-7b's 128-wide q/k
    norms, deepseek-v2-lite-16b's 512-wide latent norm), which the card
    sends to the narrow-row instances."""
    rng = np.random.default_rng(cols)
    x = (rng.standard_normal((rows, cols)) * 0.5).astype(np.float32)
    g = (rng.standard_normal(cols) * 0.5 + 1.0).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    got = rms_mod.rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (pallas_rmsnorm(jx, jg, br=8, interpret=True),
                 jref.rmsnorm(jx, jg)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=RMS_ATOL[dtype], rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ff_matches_pallas_and_oracle(dtype):
    rng = np.random.default_rng(2)
    x, wg, wu = ((rng.standard_normal((128, 128)) * 0.5).astype(np.float32)
                 for _ in range(3))
    (jx, tx), (jg, tg), (ju, tu) = (_pair(a, dtype) for a in (x, wg, wu))
    got = ff_mod.fused_ff(tx, tg, tu)
    assert got.dtype == tx.dtype and got.shape == (128, 128)
    for want in (pallas_fused_ff(jx, jg, ju, bm=64, bn=64, bk=64,
                                 interpret=True),
                 jref.fused_ff(jx, jg, ju)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=FF_ATOL[dtype], rtol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(3, 1000), (13, 2560)])
def test_rmsnorm_ragged_matches_oracle(dtype, rows, cols):
    """Shapes the Pallas kernel refuses (rows % br != 0, cols not a
    multiple of the 16-byte vector) — the port takes any."""
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, cols)) * 0.5).astype(np.float32)
    g = (rng.standard_normal(cols) * 0.5 + 1.0).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    np.testing.assert_allclose(_f32(rms_mod.rmsnorm(tx, tg)),
                               _f32(jref.rmsnorm(jx, jg)),
                               atol=RMS_ATOL[dtype], rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(3, 100, 77), (8, 129, 130), (1, 64, 96)])
def test_fused_ff_ragged_matches_oracle(dtype, m, k, n):
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((k, n)) * 0.5).astype(np.float32)
              for _ in range(2))
    (jx, tx), (jg, tg), (ju, tu) = (_pair(a, dtype) for a in (x, wg, wu))
    np.testing.assert_allclose(_f32(ff_mod.fused_ff(tx, tg, tu)),
                               _f32(jref.fused_ff(jx, jg, ju)),
                               atol=FF_ATOL[dtype], rtol=3e-2)


# Each CONFIGS entry at a few of its blocks: the port's CPU call (the plain
# version, under the wrapper's divisibility contract) against the Pallas
# kernel at the same block sizes in interpret mode.  f32 at the present
# atol; bf16 within one bf16 rounding of the output (f32 sums in another
# order on either side of a rounding boundary), plus, for K2, 1e-4 where
# a gate sum near zero loses its relative precision.
_CFG_TOL = {"rmsnorm": {"float32": (2e-5, 0.0), "bfloat16": (0.0, 2 ** -7)},
            "fused_ff": {"float32": (1e-4, 0.0),
                         "bfloat16": (1e-4, 2 ** -7)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", rms_mod.CONFIGS,
                         ids=[f"br{c['br']}-cols{c['cols']}"
                              for c in rms_mod.CONFIGS])
def test_rmsnorm_matches_pallas_at_every_config(cfg, dtype):
    rng = np.random.default_rng(cfg["br"] + cfg["cols"])
    rows, cols = 3 * cfg["br"], cfg["cols"]
    x = (rng.standard_normal((rows, cols)) * 0.5).astype(np.float32)
    g = (rng.standard_normal(cols) * 0.5 + 1.0).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    got = rms_mod.rmsnorm(tx, tg, **cfg)
    want = pallas_rmsnorm(jx, jg, br=cfg["br"], interpret=True)
    atol, rtol = _CFG_TOL["rmsnorm"][dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)
    with pytest.raises(AssertionError):     # rows % br != 0
        rms_mod.rmsnorm(tx[:-1], tg, **cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", ff_mod.CONFIGS,
                         ids=["-".join(map(str, c.values()))
                              for c in ff_mod.CONFIGS])
def test_fused_ff_matches_pallas_at_every_config(cfg, dtype):
    rng = np.random.default_rng(sum(cfg.values()))
    m, k, n = 2 * cfg["bm"], 2 * cfg["bk"], 2 * cfg["bn"]
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
              for _ in range(2))
    (jx, tx), (jg, tg), (ju, tu) = (_pair(a, dtype) for a in (x, wg, wu))
    got = ff_mod.fused_ff(tx, tg, tu, **cfg)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    want = pallas_fused_ff(jx, jg, ju, **cfg, interpret=True)
    atol, rtol = _CFG_TOL["fused_ff"][dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)
    with pytest.raises(AssertionError):     # M % bm != 0
        ff_mod.fused_ff(tx[:-1], tg, tu, **cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ff_either_side_of_the_decode_threshold(dtype):
    """M = 8 (the card's split-K decode route) and M = 9 (the wgmma route
    in bf16, SIMT in f32): the CPU wrapper against the plain version and
    the JAX oracle, at the serving path's K and a narrow N."""
    rng = np.random.default_rng(89)
    k, n = 2560, 256
    x = (rng.standard_normal((9, k)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
              for _ in range(2))
    (jx, tx), (jg, tg), (ju, tu) = (_pair(a, dtype) for a in (x, wg, wu))
    atol, rtol = _CFG_TOL["fused_ff"][dtype]
    routes = set()
    for m in (ff_mod.DECODE_ROWS, ff_mod.DECODE_ROWS + 1):
        got = ff_mod.fused_ff(tx[:m], tg, tu)
        assert torch.equal(got, ref.fused_ff(tx[:m], tg, tu))
        np.testing.assert_allclose(_f32(got),
                                   _f32(jref.fused_ff(jx[:m], jg, ju)),
                                   atol=atol, rtol=rtol)
        routes.add(ff_mod.select_tiling(tx.dtype, (m, k, n))[:4])
    assert routes == ({"gemv", "wgmm"} if dtype == "bfloat16"
                      else {"gemv", "simt"})


def test_one_row_product_equals_its_row_in_a_batch():
    """A lane computes the same bits alone as beside other lanes: the
    plain product pads a one-row operand on the CPU (PyTorch's CPU GEMM
    rounds a one-row product differently)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    batched = ref.matmul(x, w)
    for i in range(3):
        assert torch.equal(ref.matmul(x[i:i + 1], w), batched[i:i + 1])
    assert torch.equal(ref.fused_ff(x[1:2], w, w), ref.fused_ff(x, w, w)[1:2])


def test_cpu_tensors_launch_nothing():
    x = torch.randn(8, 64)
    g = torch.ones(64)
    w = torch.randn(64, 32)
    before = (rms_mod.launches, ff_mod.launches)
    assert torch.equal(rms_mod.rmsnorm(x, g), ref.rmsnorm(x, g))
    assert torch.equal(ff_mod.fused_ff(x, w, w), ref.fused_ff(x, w, w))
    assert torch.equal(ops.rmsnorm(x, g), ref.rmsnorm(x, g))
    assert torch.equal(ops.fused_ff(x, w, w), ref.fused_ff(x, w, w))
    assert (rms_mod.launches, ff_mod.launches) == before == (0, 0)


def test_non_cpu_tensors_never_fall_back():
    """Off the CPU the wrappers launch or raise: a tensor on another
    device is refused, not computed by the plain version."""
    x = torch.empty(8, 64, device="meta")
    g = torch.empty(64, device="meta")
    w = torch.empty(64, 32, device="meta")
    with pytest.raises(ValueError):
        rms_mod.rmsnorm(x, g)
    with pytest.raises(ValueError):
        ff_mod.fused_ff(x, w, w)
    with pytest.raises(ValueError):     # CUDA demanded for a CPU tensor
        ops.rmsnorm(torch.randn(2, 4), torch.ones(4), impl="cuda")
    with pytest.raises(ValueError):     # mixed devices
        rms_mod.rmsnorm(torch.randn(2, 4), torch.empty(4, device="meta"))
    with pytest.raises(ValueError):     # bad shapes
        ff_mod.fused_ff(torch.randn(2, 4), torch.randn(5, 3),
                        torch.randn(5, 3))
    assert (rms_mod.launches, ff_mod.launches) == (0, 0)


# ---------------------------------------------------------------------------
# K6 flash_attention
# ---------------------------------------------------------------------------

def _qkv(rng, shape_q, shape_kv, dtype="float32"):
    arrs = [(rng.standard_normal(s)).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(causal):
    """The Pallas kernel in interpret mode, S 256, D 64, bq = bk = 128,
    atol 2e-4 (``tests/test_kernels.py::test_flash_attention``)."""
    rng = np.random.default_rng(6)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, (1, 4, 256, 64), (1, 4, 256, 64))
    got = fa_mod.flash_attention(tq, tk, tv, causal=causal)
    want = pallas_flash_attention(jq, jk, jv, bq=128, bk=128, causal=causal,
                                  interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(256, 64), (512, 32)])
def test_flash_attention_plain_matches_oracle(causal, s, d):
    rng = np.random.default_rng(s + d)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, (1, 4, s, d), (1, 4, s, d))
    np.testing.assert_allclose(
        _f32(ops.flash_attention(tq, tk, tv, causal=causal)),
        _f32(jref.flash_attention(jq, jk, jv, causal=causal)), atol=2e-4)


def test_flash_attention_plain_matches_oracle_bf16():
    """``test_flash_attention_paper_config``: bf16, S 1024, D 32, atol
    3e-2."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, (1, 4, 1024, 32),
                                        (1, 4, 1024, 32), "bfloat16")
    got = ref.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(jref.flash_attention(jq, jk,
                                                                    jv)),
                               atol=3e-2)


def test_flash_attention_causal_alignment_with_fewer_queries():
    """With Sq != Sk the JAX package's two causal attentions disagree: the
    Pallas kernel masks k <= q aligned top-left (its rows start at key 0),
    the jnp oracle aligns bottom-right (its last row sees every key).  The
    port places row i at ``q_offset + i``: q_offset 0 is the kernel's
    alignment, q_offset Sk - Sq the oracle's.  On the card the CUDA kernel
    is held against this plain version only (``chip_smoke.py``)."""
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, (1, 2, 128, 64), (1, 2, 256, 64))
    top_left = pallas_flash_attention(jq, jk, jv, bq=128, bk=128,
                                      causal=True, interpret=True)
    np.testing.assert_allclose(_f32(ref.flash_attention(tq, tk, tv)),
                               _f32(top_left), atol=2e-4)
    np.testing.assert_allclose(
        _f32(ref.flash_attention(tq, tk, tv, q_offset=128)),
        _f32(jref.flash_attention(jq, jk, jv)), atol=2e-4)


# ---------------------------------------------------------------------------
# the autograd Functions (on the CPU their forward is the plain version)
# ---------------------------------------------------------------------------

def _grads_close(got, want, atol, rtol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=atol, rtol=rtol)


def test_rmsnorm_function_gradients_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((24, 96)).astype(np.float32)
    g = (rng.standard_normal(96) * 0.5 + 1.0).astype(np.float32)
    dy = rng.standard_normal((24, 96)).astype(np.float32)
    tx, tg = (torch.from_numpy(a).requires_grad_() for a in (x, g))
    y = rms_mod.RMSNormFunction.apply(tx, tg, 1e-6)
    got = torch.autograd.grad(y, (tx, tg), torch.from_numpy(dy))
    _, vjp = jax.vjp(jref.rmsnorm, jnp.asarray(x), jnp.asarray(g))
    _grads_close(got, vjp(jnp.asarray(dy)), atol=1e-5)
    assert rms_mod.launches == 0


def test_fused_ff_function_gradients_match_jax():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((40, 64)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((64, 96)) * 0.2).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((40, 96)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wg, wu)]
    got = torch.autograd.grad(ff_mod.FusedFFFunction.apply(*ts), ts,
                              torch.from_numpy(dy))
    _, vjp = jax.vjp(jref.fused_ff, *(jnp.asarray(a) for a in (x, wg, wu)))
    _grads_close(got, vjp(jnp.asarray(dy)), atol=1e-4)
    assert ff_mod.launches == 0


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, ref.NO_WINDOW, 0), (True, 24, 40), (False, 32, 0)])
def test_flash_attention_function_gradients(causal, window, q_offset,
                                            monkeypatch):
    """The Function's backward (the plain version's gradient, recomputed a
    batch row and a KV-head group at a time — forced to one head here)
    against autograd through the plain version in one piece, with GQA;
    and, for the kernel's own case, against JAX's gradient of its jnp
    oracle."""
    monkeypatch.setattr(fa_mod, "_BACKWARD_ENTRIES", 1)
    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4, 80, 16), (2, 2, 80, 16), (2, 2, 80, 16))]
    dy = rng.standard_normal((2, 4, 80, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    got = torch.autograd.grad(
        fa_mod.FlashAttentionFunction.apply(*ts, causal, window, q_offset,
                                            None), ts, torch.from_numpy(dy))
    want = torch.autograd.grad(ref.flash_attention(*ts, **kw), ts,
                               torch.from_numpy(dy))
    _grads_close(got, want, atol=1e-5)
    if window == ref.NO_WINDOW and q_offset == 0:
        # the oracle has no GQA: repeat each KV head for its query heads
        jq, jk, jv = (jnp.asarray(a) for a in arrs)
        _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(
            q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1),
            causal=causal), jq, jk, jv)
        _grads_close(got, vjp(jnp.asarray(dy)), atol=1e-4)
    assert fa_mod.launches == 0


def test_flash_attention_dispatch():
    """CPU tensors take the plain version (v's head dim may differ from
    q's, as MLA's); other devices launch or raise; malformed inputs raise
    before either."""
    q = torch.randn(1, 4, 8, 16)
    kv = torch.randn(1, 2, 8, 16)
    assert torch.equal(fa_mod.flash_attention(q, kv, kv),
                       ref.flash_attention(q, kv, kv))
    meta = [torch.empty(t.shape, device="meta") for t in (q, kv, kv)]
    with pytest.raises(ValueError):
        fa_mod.flash_attention(*meta)
    with pytest.raises(ValueError):     # H not a multiple of KH
        fa_mod.flash_attention(torch.randn(1, 3, 8, 16), kv, kv)
    v8 = torch.randn(1, 2, 8, 8)        # Dv != D (MLA) is taken
    out = fa_mod.flash_attention(q, kv, v8)
    assert out.shape == (1, 4, 8, 8)
    assert torch.equal(out, ref.flash_attention(q, kv, v8))
    with pytest.raises(ValueError):     # v's keys are not k's
        fa_mod.flash_attention(q, kv, torch.randn(1, 2, 7, 16))
    with pytest.raises(ValueError):
        fa_mod.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError):     # forced onto the kernel on the CPU
        with ops.forced("cuda"):
            ops.flash_attention(q, kv, kv)
    assert fa_mod.launches == 0


# ---------------------------------------------------------------------------
# K3 matmul_leakyrelu and K4 bmm
# ---------------------------------------------------------------------------

GEMM_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py:18


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 128, 256, 128, 128, 128),
    (128, 256, 128, 64, 128, 64),
])
def test_matmul_leakyrelu_matches_pallas_and_oracle(dtype, m, n, k, bm, bn,
                                                    bk):
    """``tests/test_kernels.py::test_matmul_leakyrelu``'s cases."""
    rng = np.random.default_rng(m + n + k)
    a = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.5).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = KERNELS["matmul_leakyrelu"].kernel_fn(ta, tb, bm=bm, bn=bn, bk=bk)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    for want in (pallas_matmul_leakyrelu(ja, jb, bm=bm, bn=bn, bk=bk,
                                         interpret=True),
                 jref.matmul_leakyrelu(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=GEMM_ATOL[dtype], rtol=2e-2)
    assert torch.equal(got, ops.matmul_leakyrelu(ta, tb))
    assert (got < 0).any() and (got > 0).any()       # both epilogue sides


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bmm_matches_pallas_and_oracle(dtype):
    """``tests/test_kernels.py::test_bmm``: 3 x 128^3 in 64-tiles."""
    rng = np.random.default_rng(1)
    a, b = ((rng.standard_normal((3, 128, 128)) * 0.5).astype(np.float32)
            for _ in range(2))
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = KERNELS["bmm"].kernel_fn(ta, tb, bm=64, bn=64, bk=64)
    assert got.dtype == ta.dtype and got.shape == (3, 128, 128)
    for want in (pallas_bmm(ja, jb, bm=64, bn=64, bk=64, interpret=True),
                 jref.bmm(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=GEMM_ATOL[dtype], rtol=2e-2)
    assert torch.equal(got, ops.bmm(ta, tb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_versions_take_any_shape(dtype):
    """Shapes no block size divides, against the jnp oracles (the plain
    versions, like the oracles and the CUDA kernel, take any shape)."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((37, 70)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((70, 19)) * 0.5).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    np.testing.assert_allclose(
        _f32(ref.matmul_leakyrelu(ta, tb, 0.2)),
        _f32(jref.matmul_leakyrelu(ja, jb, negative_slope=0.2)),
        atol=GEMM_ATOL[dtype], rtol=2e-2)
    a3 = (rng.standard_normal((2, 5, 33)) * 0.5).astype(np.float32)
    b3 = (rng.standard_normal((2, 33, 9)) * 0.5).astype(np.float32)
    (ja3, ta3), (jb3, tb3) = _pair(a3, dtype), _pair(b3, dtype)
    np.testing.assert_allclose(_f32(ref.bmm(ta3, tb3)),
                               _f32(jref.bmm(ja3, jb3)),
                               atol=GEMM_ATOL[dtype], rtol=2e-2)


def test_gemm_wrappers_keep_the_reference_contract():
    """The reference's divisibility assertion; CPU tensors launch nothing;
    tensors elsewhere launch the kernel or raise, never the plain
    version."""
    a, b = torch.randn(128, 64), torch.randn(64, 128)
    with pytest.raises(AssertionError):
        mlr_mod.matmul_leakyrelu(a, b, bk=128)
    with pytest.raises(AssertionError):
        mlr_mod.matmul_leakyrelu(a, torch.randn(32, 128), bk=32)  # K != K2
    with pytest.raises(AssertionError):
        bmm_mod.bmm(torch.randn(2, 96, 64), torch.randn(2, 64, 64), bm=64,
                    bn=64, bk=64)
    assert torch.equal(mlr_mod.matmul_leakyrelu(a, b, bk=64),
                       ref.matmul_leakyrelu(a, b))
    a3, b3 = torch.randn(2, 64, 64), torch.randn(2, 64, 64)
    assert torch.equal(bmm_mod.bmm(a3, b3, bm=64, bn=64, bk=64),
                       ref.bmm(a3, b3))
    with pytest.raises(ValueError):
        mlr_mod.matmul_leakyrelu(torch.empty(128, 128, device="meta"),
                                 torch.empty(128, 128, device="meta"))
    with pytest.raises(ValueError):
        bmm_mod.bmm(torch.empty(1, 128, 128, device="meta"),
                    torch.empty(1, 128, 128, device="meta"))
    with pytest.raises(ValueError):     # mixed devices
        bmm_mod.bmm(a3, torch.empty(2, 64, 64, device="meta"), bm=64, bn=64,
                    bk=64)
    with pytest.raises(ValueError):     # CUDA demanded for CPU tensors
        ops.matmul_leakyrelu(a, b, bk=64, impl="cuda")
    with pytest.raises(ValueError):
        ops.bmm(a3, b3, impl="cuda")
    with pytest.raises(ValueError):     # bad ranks
        bmm_mod.bmm(a, b)
    assert (mlr_mod.launches, bmm_mod.launches) == (0, 0)


# ---------------------------------------------------------------------------
# K5 softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols,br", [(512, 4096, 8), (64, 1024, 16)])
def test_softmax_matches_pallas_and_oracle(dtype, rows, cols, br):
    """``tests/test_kernels.py::test_softmax_paper_config``'s shapes and
    inputs (N(0, 4)): f32 at its atol 2e-6; bf16 within one bf16 rounding
    of the output (the f32 results on either side of a rounding
    boundary)."""
    rng = np.random.default_rng(rows + cols)
    x = (rng.standard_normal((rows, cols)) * 2.0).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = KERNELS["softmax"].kernel_fn(tx, br=br)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = (dict(atol=2e-6, rtol=0) if dtype == "float32"
           else dict(atol=0, rtol=2 ** -7))
    for want in (pallas_softmax(jx, br=br, interpret=True),
                 jref.softmax(jx)):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert torch.equal(got, ops.softmax(tx))
    np.testing.assert_allclose(_f32(got).sum(-1), 1.0, atol=1e-3)


def test_softmax_wrapper_keeps_the_reference_contract():
    """rows % br == 0 as the reference asserts, a config's cols must be
    x's width; CPU tensors launch nothing; tensors elsewhere launch or
    raise, never the plain version."""
    x = torch.randn(16, 64)
    with pytest.raises(AssertionError):
        sm_mod.softmax(x, br=3)
    with pytest.raises(ValueError):
        sm_mod.softmax(x, cols=128)
    assert torch.equal(sm_mod.softmax(x, br=8, cols=64), ref.softmax(x))
    assert torch.equal(ops.softmax(x, impl="ref"), ref.softmax(x))
    with pytest.raises(ValueError):
        sm_mod.softmax(torch.empty(8, 64, device="meta"))
    with pytest.raises(ValueError):     # CUDA demanded for a CPU tensor
        ops.softmax(x, impl="cuda")
    with pytest.raises(ValueError):     # bad rank
        sm_mod.softmax(torch.randn(2, 3, 4))
    assert sm_mod.launches == 0


# ---------------------------------------------------------------------------
# the registry: every kernel called as a deployed config calls it
# ---------------------------------------------------------------------------

def _config_inputs(name, cfg, rng):
    """Inputs of the shapes a deployed config allows, in f32 on the CPU."""
    def t(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.5).astype(np.float32))
    if name == "rmsnorm":
        return t(2 * cfg["br"], cfg["cols"]), t(cfg["cols"]) + 1.0
    if name == "softmax":
        return (t(2 * cfg["br"], cfg["cols"]),)
    if name == "flash_attention":
        return (t(1, 2, cfg["bq"], cfg["d"]),
                t(1, 2, 2 * cfg["bk"], cfg["d"]),
                t(1, 2, 2 * cfg["bk"], cfg["d"]))
    if name == "bmm":
        return (t(2, cfg["bm"], cfg["bk"]), t(2, cfg["bk"], cfg["bn"]))
    if name == "ssd":      # flat (BH, S, ...), S two chunks, a <= 0
        S = 2 * cfg["chunk"]
        return (t(2, S, cfg["p"]), -t(2, S).abs(), t(2, S, cfg["n"]),
                t(2, S, cfg["n"]))
    m, n, k = cfg["bm"], cfg["bn"], 2 * cfg["bk"]
    if name == "fused_ff":
        return t(m, k), t(k, n), t(k, n)
    return t(m, k), t(k, n)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_registry_kernels_take_every_config(name):
    """``kernel_fn(*inputs, **config)`` at every ``CONFIGS`` entry equals
    ``ref_fn`` on CPU tensors (as ``chip_smoke.py`` launches the deployed
    configs on the card); shapes the config's block sizes do not divide
    fail the reference's assertion, and a config's shape key (``cols``,
    ``d``, ``p``) that is not the input's raises.  (``ssd``'s plain version
    takes the config's chunk: it blocks the sum, which moves the f32
    rounding.)"""
    kdef = KERNELS[name]
    rng = np.random.default_rng(7)
    for cfg in kdef.configs:
        inputs = _config_inputs(name, cfg, rng)
        chunk = {"chunk": cfg["chunk"]} if name == "ssd" else {}
        assert torch.equal(kdef.kernel_fn(*inputs, **cfg),
                           kdef.ref_fn(*inputs, **chunk))
    cfg = kdef.configs[0]
    inputs = _config_inputs(name, cfg, rng)
    shape_key = {"rmsnorm": "cols", "softmax": "cols",
                 "flash_attention": "d", "ssd": "p"}.get(name)
    if shape_key is not None:
        with pytest.raises(ValueError):
            kdef.kernel_fn(*inputs, **dict(cfg, **{shape_key: 7}))
    # one row (one query, for attention; one position, for ssd) fewer:
    # bm/br/bq/chunk no longer divide
    if name == "flash_attention":
        cut = [inputs[0][:, :, :-1], *inputs[1:]]
    elif name == "ssd":
        cut = [t[:, :-1] for t in inputs]
    elif name == "bmm":
        cut = [inputs[0][:, :-1], inputs[1]]
    else:
        cut = [inputs[0][:-1], *inputs[1:]]
    with pytest.raises(AssertionError):
        kdef.kernel_fn(*cut, **cfg)
    assert rms_mod.launches == sm_mod.launches == ssd_mod.launches == 0
