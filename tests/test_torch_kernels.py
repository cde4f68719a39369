"""The port's kernel modules on the CPU: the plain versions of ``rmsnorm``
and ``fused_ff`` against the JAX package's Pallas kernels (interpret mode)
and its jnp oracles, on the same seeded numpy inputs; and the wrappers'
dispatch rules (a CPU tensor takes the plain version and launches
nothing; anything else launches the kernel or raises).

Tolerances are those of ``tests/test_kernels.py`` for the same kernels:
f32 atol 2e-5 (rmsnorm) / 1e-4 (fused_ff, 128-term dot products summed
in another order), bf16 atol 2e-2 / 5e-2 (one bf16 rounding of the
output, plus bf16 operands), rtol 2e-2 / 3e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_ff import fused_ff as pallas_fused_ff
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import fused_ff as ff_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_mod

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
