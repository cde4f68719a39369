"""The port's SSM slice against the JAX package, on the CPU: the plain
versions of K7 ``ssd`` (the registry's flat call and the model layout)
against the Pallas kernel in interpret mode and the jnp scan oracle, and
their gradient against ``jax.grad`` of the oracle; ``nn/ssm.py``
(``apply_ssm`` with parameters carried across, decode against the
parallel path); the forward logits and one train step of reduced
mamba2-1.3b; and the wrappers' dispatch rules.  Inputs come from numpy
seeds and go to both frameworks; tolerances are stated where they are
used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as pallas_ssd
from repro.models import lm as jlm
from repro.nn.core import init_params as jax_init_params
from repro.train.step import loss_fn as jax_loss_fn
from repro.utils.tree import global_norm as jax_global_norm
from repro_torch import nn
from repro_torch.configs import get_config
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import compute_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.optim import adamw
from repro_torch.utils.tree import global_norm, tree_leaves

ARCH = "mamba2-1.3b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ssd_inputs(rng, B, S, H, G, P, N, decay):
    """x, b, c ~ N(0, 1); a = -|N(0, 1)| * decay, or, for a strong decay
    (``decay=None``), -3 - U(0, 1) at every step."""
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if decay is None:
        a = (-3.0 - rng.random((B, S, H))).astype(np.float32)
    else:
        a = (-np.abs(rng.standard_normal((B, S, H))) * decay).astype(
            np.float32)
    b, c = (rng.standard_normal((B, S, G, N)).astype(np.float32)
            for _ in range(2))
    return x, a, b, c


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K7 ssd: the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [32, 64])
def test_flat_ssd_matches_pallas_and_oracle(chunk):
    """``tests/test_kernels.py::test_ssd_vs_scan_oracle``'s case
    (BH 2, S 128, P 32, N 16; a = -|N(0, 1)| * 0.2) at its atol = rtol =
    1e-3, through the registry's ``kernel_fn`` and ``ops.ssd`` on CPU
    tensors.  Measured: the port lies within 1.6e-5 of the Pallas kernel
    and within 5.8e-6 of the scan oracle (|y| up to 50)."""
    rng = np.random.default_rng(8)
    x, a, b, c = (t[:, :, 0] for t in _ssd_inputs(rng, 2, 128, 1, 1, 32,
                                                   16, 0.2))
    got = KERNELS["ssd"].kernel_fn(*_torch(x, a, b, c), chunk=chunk)
    assert got.shape == (2, 128, 32) and got.dtype == torch.float32
    assert torch.equal(got, ops.ssd(*_torch(x, a, b, c), chunk=chunk))
    assert torch.equal(got, ref.ssd(*_torch(x, a, b, c), chunk))
    jx, ja, jb, jc = _jax(x, a, b, c)
    for want in (pallas_ssd(jx, ja, jb, jc, chunk=chunk, interpret=True),
                 jref.ssd_chunk(jx[:, :, None], ja[:, :, None],
                                jb[:, :, None], jc[:, :, None])[:, :, 0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("S,chunk,decay", [(100, 64, 0.5), (100, 32, 0.5),
                                           (130, 64, None)])
def test_model_layout_ssd_matches_oracle(S, chunk, decay):
    """Two groups over four heads, S not a multiple of the chunk, and a
    strong decay (-3 or less a step: a chunk's decay passes 88, where an
    unmasked ``e^{seg_t - seg_s}`` would overflow): against the scan
    oracle at the reference test's atol = rtol = 1e-3, every output
    finite.  Measured: within 5.8e-6 (|y| up to 48)."""
    rng = np.random.default_rng(S + chunk)
    arrays = _ssd_inputs(rng, 2, S, 4, 2, 8, 16, decay)
    got = ref.ssd_chunk(*_torch(*arrays), chunk)
    want = np.asarray(jref.ssd_chunk(*_jax(*arrays)))
    assert got.shape == (2, S, 4, 8) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    assert torch.equal(ops.ssd_chunk(*_torch(*arrays), chunk=chunk), got)


@pytest.mark.parametrize("decay", [0.5, None])
def test_ssd_gradient_matches_jax(decay):
    """Autograd through the plain version against ``jax.grad`` of the
    scan oracle, for x, a, b and c, with a random cotangent; f32 against
    f32 at atol 1e-4 relative to each gradient's largest entry (sums of
    up to 100 terms in another order; measured 4e-7), every gradient
    finite also under a strong decay."""
    rng = np.random.default_rng(3)
    arrays = _ssd_inputs(rng, 2, 100, 4, 2, 8, 16, decay)
    w = rng.standard_normal((2, 100, 4, 8)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _torch(*arrays)]
    (ref.ssd_chunk(*leaves, 32) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *t: jnp.sum(jref.ssd_chunk(*t) * w),
                    argnums=(0, 1, 2, 3))(*_jax(*arrays))
    for got, jg in zip(leaves, want):
        jg = np.asarray(jg)
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max())


def test_ssd_wrappers_keep_the_reference_contract():
    """The flat call asserts S % chunk == 0 and a (BH, S), as the
    reference; a config's p and n must be the operands'; CPU tensors
    launch nothing; tensors elsewhere launch or raise, never the plain
    version; ``SSDFunction``'s gradient on CPU tensors is the plain
    version's."""
    rng = np.random.default_rng(0)
    x, a, b, c = _torch(*(t[:, :, 0] for t in _ssd_inputs(
        rng, 2, 64, 1, 1, 8, 16, 0.5)))
    with pytest.raises(AssertionError):
        ssd_mod.ssd(x[:, :-1], a[:, :-1], b[:, :-1], c[:, :-1], chunk=32)
    with pytest.raises(AssertionError):
        ssd_mod.ssd(x, a[:, :-1], b, c, chunk=32)
    with pytest.raises(ValueError):
        ssd_mod.ssd(x, a, b, c, chunk=32, p=9)
    with pytest.raises(ValueError):
        ssd_mod.ssd(x, a, b, c, chunk=32, n=9)
    assert torch.equal(ssd_mod.ssd(x, a, b, c, chunk=32, p=8, n=16),
                       ref.ssd(x, a, b, c, 32))
    with pytest.raises(ValueError):     # H not a multiple of G
        ssd_mod.ssd_chunk(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3),
                          torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16))
    meta = [torch.empty(t.shape, device="meta") for t in (x, a, b, c)]
    with pytest.raises(ValueError):
        ssd_mod.ssd(*meta, chunk=32)
    with pytest.raises(ValueError):     # CUDA demanded for a CPU tensor
        ops.ssd(x, a, b, c, impl="cuda")
    leaves = [t[:, :, None].clone().requires_grad_() for t in (x, a, b, c)]
    y = ssd_mod.SSDFunction.apply(*leaves, 32)
    grads = torch.autograd.grad(y.sum(), leaves)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(ref.ssd_chunk(*plain, 32).sum(), plain)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert ssd_mod.launches == 0


def _bf16_ssd_tol(want):
    """``chip_smoke.py::ssd_tol``'s bf16 bound: 2^-12 of the largest
    output, plus one bf16 rounding of the output (2^-7 relative)."""
    return 2 ** -12 * want.float().abs().max().item(), 2 ** -7


@pytest.mark.parametrize("chunk,segments,decay", [
    (64, 1, 0.5), (64, 3, 0.5), (128, 2, 0.5), (64, 3, None),
    (128, 2, None)])
def test_chunk_parallel_bf16_holds_the_kernels_bound(chunk, segments, decay):
    """``csrc/ssd.cu``'s decomposition with the wgmma route's rounding
    points (bf16 operands; M, the incoming states and the weighted X as
    bf16 pairs), rendered by ``ref.ssd_chunk_parallel``, against the
    plain version at the card's bf16 bound, at mamba2-1.3b's widths (P
    64, N 128, one group) cut to 2 heads and 512 positions, under
    mamba2's decay and a strong one."""
    rng = np.random.default_rng(chunk + segments)
    x, a, b, c = _ssd_inputs(rng, 1, 512, 2, 1, 64, 128, decay)
    x, b, c = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, b, c))
    a = torch.from_numpy(a)
    got = ref.ssd_chunk_parallel(x, a, b, c, chunk, segments)
    want = ref.ssd_chunk(x, a, b, c, chunk)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    atol, rtol = _bf16_ssd_tol(want)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_chunk_parallel_bf16_needs_the_pairs(monkeypatch):
    """Why the wgmma route splits its f32 intermediates: rounding M, the
    states and the weighted X to one bf16 each misses the bound that the
    pairs hold (same inputs as the case above, chunk 64, 3 segments)."""
    rng = np.random.default_rng(67)
    x, a, b, c = _ssd_inputs(rng, 1, 512, 2, 1, 64, 128, 0.5)
    x, b, c = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, b, c))
    a = torch.from_numpy(a)
    want = ref.ssd_chunk(x, a, b, c, 64)
    atol, rtol = _bf16_ssd_tol(want)
    assert torch.allclose(ref.ssd_chunk_parallel(x, a, b, c, 64, 3).float(),
                          want.float(), atol=atol, rtol=rtol)
    monkeypatch.setattr(ref, "_bf16_pair",
                        lambda v: v.to(torch.bfloat16).float())
    single = ref.ssd_chunk_parallel(x, a, b, c, 64, 3)
    assert not torch.allclose(single.float(), want.float(), atol=atol,
                              rtol=rtol)


@pytest.mark.parametrize("S,chunk,segments,decay", [
    (512, 64, 3, 0.5), (512, 128, 2, 0.5), (300, 64, 4, None)])
def test_chunk_parallel_f32_matches_oracle(S, chunk, segments, decay):
    """The decomposition in f32 (the SIMT route's arithmetic) against the
    JAX package's scan oracle at the reference test's atol = rtol = 1e-3,
    and against the plain version at the card's f32 bound (1e-5 of the
    largest output), at mamba2's widths cut to 2 heads."""
    rng = np.random.default_rng(S + chunk)
    arrays = _ssd_inputs(rng, 1, S, 2, 1, 64, 128, decay)
    got = ref.ssd_chunk_parallel(*_torch(*arrays), chunk, segments)
    want = np.asarray(jref.ssd_chunk(*_jax(*arrays)))
    assert got.shape == (1, S, 2, 64) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    plain = ref.ssd_chunk(*_torch(*arrays), chunk)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=1e-5 * plain.abs().max().item())


# ---------------------------------------------------------------------------
# nn/ssm.py
# ---------------------------------------------------------------------------

SSM_CFG = dict(d_model=32, d_inner=64, n_heads=4, head_p=16, n_groups=2,
               d_state=16)


def _ssm_params():
    jp = jax_init_params(jnn.ssm_spec(jnn.SSMConfig(**SSM_CFG)),
                         jax.random.PRNGKey(0))
    # the reference's zero a_log / dt_bias give every head one decay:
    # spread them so that heads and groups differ
    rng = np.random.default_rng(4)
    for key in ("a_log", "dt_bias"):
        jp[key] = jnp.asarray(rng.standard_normal(4).astype(np.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


@pytest.mark.parametrize("S", [12, 100])
def test_apply_ssm_matches_jax(S):
    """``apply_ssm`` (projections, causal conv, the SSD scan in chunks of
    64, the gated rmsnorm) with the reference's parameters; f32 against
    f32 at atol 1e-5 (outputs up to about 3.6, sums in another order;
    measured 1.8e-6)."""
    jp, tp = _ssm_params()
    x = (np.random.default_rng(S).standard_normal((2, S, 32)) * 0.5).astype(
        np.float32)
    want = np.asarray(jnn.apply_ssm(jp, jnp.asarray(x),
                                    jnn.SSMConfig(**SSM_CFG)))
    got = nn.apply_ssm(tp, torch.from_numpy(x), nn.SSMConfig(**SSM_CFG))
    assert got.shape == (2, S, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_ssm_decode_equals_parallel():
    """``tests/test_nn.py::test_ssm_decode_equals_parallel`` on the port:
    12 one-token decode steps equal the parallel path at its atol 3e-5
    (n_groups 2)."""
    cfg = nn.SSMConfig(**SSM_CFG)
    _, p = _ssm_params()
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, 12, 32)) * 0.5).astype(np.float32))
    y_par = nn.apply_ssm(p, x, cfg)
    cache = nn.init_ssm_cache(cfg, 2)
    outs = []
    for t in range(12):
        yt, cache = nn.apply_ssm_decode(p, x[:, t:t + 1], cache, cfg)
        outs.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               atol=3e-5)


# ---------------------------------------------------------------------------
# reduced mamba2-1.3b: forward and one train step
# ---------------------------------------------------------------------------

def _carried(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def test_forward_logits_match_jax():
    """f32 logits of (2, 64) tokens (one full chunk), at the bound
    ``tests/test_torch_train.py`` uses for dense: atol 1e-4 plus twice the
    reference's error against the port's f64 evaluation, which must lie
    within 1e-3 of the reference (it lies about 1.5e-4 from it; |logits|
    up to 33).  The port's SSD sums its decay exponents as they stand
    (``kernels/ref.py::ssd_chunk``): as differences of running sums its
    error exceeded this bound."""
    jcfg = jax_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
    want = np.asarray(jlm.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                  jcfg))
    got = lm.forward(_carried(jparams, cfg), torch.from_numpy(tokens), cfg)
    cfg64 = cfg.replace(dtype="float64")
    exact = lm.forward(_carried(jparams, cfg64), torch.from_numpy(tokens),
                       cfg64).numpy()
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == torch.float32
    jax_err = float(np.abs(want.astype(np.float64) - exact).max())
    assert jax_err <= 1e-3, jax_err
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-4 + 2 * jax_err, rtol=0)


def _close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


def test_train_step_matches_jax():
    """One train step under the stablelm bounds of ROADMAP §C: the loss
    within 1e-5 relative; each gradient leaf within atol 1e-5 and the
    grad-norm within 1e-5 relative, each plus twice the reference's own
    error against the port's f64 gradients; the port's train step
    reports that loss within 1e-5 and that grad-norm within 3e-4
    relative (the bound of its metric in the stablelm test)."""
    jcfg = jax_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    nb = jax_make_data(jcfg, 32, 4, seed=5).batch_at(2)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    params = _carried(jparams, cfg)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    loss, grads = compute_grads(params, batch, cfg)
    cfg64 = cfg.replace(dtype="float64")
    _, exact = compute_grads(_carried(jparams, cfg64), batch, cfg64)
    assert _close(loss, jloss, 1e-5)
    exact_norm = float(global_norm(exact))
    norm_err = abs(float(jax_global_norm(jgrads)) - exact_norm) / exact_norm
    assert norm_err <= 1e-2
    assert _close(global_norm(grads), jax_global_norm(jgrads),
                  1e-5 + 2 * norm_err)
    for g, jg, e in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                        tree_leaves(exact)):
        jg, e = np.asarray(jg), e.numpy()
        jax_err = float(np.abs(jg - e).max())
        assert jax_err <= 1e-2 * float(np.abs(e).max()), jax_err
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-5 + 2 * jax_err,
                                   rtol=0)

    # the port's step reports the same loss and pre-clipping grad-norm
    opt = adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    state, m = make_train_step(cfg, opt)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)), batch)
    assert _close(m["loss"], jloss, 1e-5)
    assert _close(m["grad_norm"], jax_global_norm(jgrads), 3e-4)
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))


def test_families_without_a_forward_raise(tmp_path):
    """``lm``'s model refuses the encoder-decoder, naming the module that
    builds it (``models.encdec``), as the reference's ``lm`` refuses it.
    The moe family's forward with a mesh (no longer refused) takes the
    expert-parallel dispatch: on (model=2), 2 gloo ranks each with its
    blocks of the parameters (``tests/torch_gspmd_ranks.py``), at a
    capacity factor without drops (8.0, the reference EP test's), the
    logits lie within 1e-4 plus 1e-6 of their scale of the mesh-less
    forward's (the same function, its sums in other orders)."""
    import torch_gspmd_ranks as ranks
    from repro_torch.launch.mesh import run_ranks
    whisper = get_config("whisper-large-v3", reduced=True)
    with pytest.raises(ValueError, match="models.encdec"):
        lm.model_spec(whisper)
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(
        capacity_factor=8.0)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    run_ranks(ranks.moe_forward, 2, str(tmp_path),
              {k: v.numpy() for k, v in ranks.flat(params)}, tokens,
              init_method=f"file://{tmp_path}/pg", timeout_s=180)
    got = torch.load(tmp_path / "moe_forward.pt", weights_only=False)
    want = lm.forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 + 1e-6 * float(np.abs(want).max()))
