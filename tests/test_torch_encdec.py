"""The port's encoder-decoder family (whisper-large-v3, reduced: 2 + 2
layers, d 64, 4 heads of 16, vocab 128, attention chunk 32) against the
JAX package, on the CPU: the parameter tree crossing with
``params_from_jax``, ``encode`` and the forward logits (frames = tokens,
and more frames than tokens), one train step, remat checkpointing each
layer, decode over zero cross caches and over cross caches filled from
the encoder, ``generate()``'s streams, and serving's refusals.  Inputs
come from numpy seeds and go to both frameworks; bounds are ROADMAP §C's
dense rules, stated where they are used."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import repro.serve as jserve
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import encdec as jencdec
from repro.nn.core import apply_dense as jax_apply_dense
from repro.serve.decode import decode_step as jax_decode_step
from repro.serve.decode import init_caches as jax_init_caches
from repro.train.step import loss_fn as jax_loss_fn
from repro.utils.tree import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
from repro_torch.data.pipeline import make_data
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, for_config, lm
from repro_torch.models.convert import params_from_jax
from repro_torch.nn.core import apply_dense
from repro_torch.optim import adamw
from repro_torch.serve import (ServeEngine, decode_step, generate,
                               init_caches)
from repro_torch.serve.decode import paged_cache_kinds
from repro_torch.train import compute_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.utils.tree import global_norm, tree_leaves

# chip_smoke.py's helpers, one copy for the card and the tests:
# ``per_layer_fan_in`` and ``fill_cross``
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = "whisper-large-v3"
LOGIT_ATOL = 1e-4            # the dense decode and forward atol (§C)
SAME_FUNCTION_ATOL = 1e-3    # the reference against the port's f64
# The reference's init draws a stacked leaf with the layer count as its
# fan-in: variance 1/2 at 2 layers, where the reduced model is chaotic in
# f32 (its logits lie up to 3.7e-2 from f64 in both packages;
# tools/encdec_parity_witness.py, ROADMAP §C).  Both packages here take
# PRNGKey(0)'s draw with every stacked layer matrix rescaled to its own
# fan-in (``chip_smoke.per_layer_fan_in``), as chip_smoke.py's phase 3
# does, and the dense rules hold unchanged.

_MODEL = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _jax_model():
    """The reference's config and its PRNGKey(0) parameters at each
    layer's own fan-in, as a tree of numpy arrays and of JAX arrays."""
    if not _MODEL:
        jcfg = jax_get_config(ARCH, reduced=True)
        tree = smoke.per_layer_fan_in(jax.tree.map(
            np.asarray, jencdec.init_model(jcfg, jax.random.PRNGKey(0))))
        _MODEL["jax"] = (jcfg, tree, jax.tree.map(jnp.asarray, tree))
    return _MODEL["jax"]


def _carried(cfg):
    _, tree, _ = _jax_model()
    return params_from_jax(tree, cfg)


def _close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


def _assert_close_to_jax(port, jax_out, exact):
    """Port f32 against the reference's f32 on one function, by the rule
    of ``tests/test_torch_serve.py::_assert_logits_close``: within atol
    1e-4 plus twice the reference's own error against ``exact`` (the
    port's f64 evaluation), which must itself lie within 1e-3 of the
    reference."""
    want = np.asarray(jax_out, np.float64)
    jax_err = float(np.abs(want - np.asarray(exact, np.float64)).max())
    assert jax_err <= SAME_FUNCTION_ATOL, jax_err
    np.testing.assert_allclose(np.asarray(port, np.float64), want,
                               atol=LOGIT_ATOL + 2 * jax_err, rtol=0)


def _inputs(cfg, batch, n_frames, n_tokens, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, n_frames, cfg.d_model))
    return (frames.astype(np.float32),
            rng.integers(0, cfg.vocab, (batch, n_tokens)))


def test_params_from_jax_takes_the_encdec_tree():
    """The JAX tree (stacked encoder and decoder layers, the encoder's
    norm) crosses leaf for leaf through ``for_config``'s spec; a missing
    subtree, an extra leaf or a misshapen leaf is refused."""
    cfg = get_config(ARCH, reduced=True)
    assert for_config(cfg) is encdec
    _, tree, _ = _jax_model()
    params = params_from_jax(tree, cfg)
    assert set(params) == {"embed", "enc_layers", "enc_norm", "dec_layers",
                           "final_norm"}
    assert params["dec_layers"]["cross"]["wq"]["w_b"].shape == (
        cfg.dec_layers, cfg.n_heads * cfg.head_dim)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(tree)):
        assert np.array_equal(got.numpy(), want)
    bad = dict(tree)
    del bad["enc_norm"]
    with pytest.raises(ValueError, match="root"):
        params_from_jax(bad, cfg)
    bad = jax.tree.map(np.copy, tree)
    bad["dec_layers"]["ln_x"]["extra"] = bad["dec_layers"]["ln_x"]["bias"]
    with pytest.raises(ValueError, match="dec_layers/ln_x"):
        params_from_jax(bad, cfg)
    bad = jax.tree.map(np.copy, tree)
    bad["dec_layers"]["cross"]["wk"]["w_b"] = \
        bad["dec_layers"]["cross"]["wk"]["w_b"][:, :-1]
    with pytest.raises(ValueError, match="dec_layers/cross/wk/w_b"):
        params_from_jax(bad, cfg)


@pytest.mark.parametrize("n_frames,n_tokens", [(32, 32), (64, 16)],
                         ids=["frames_eq_tokens", "more_frames"])
def test_encode_and_forward_match_jax(n_frames, n_tokens):
    """f32 encoder states and logits of 2 rows, frames = tokens = 32 and
    64 frames against 16 tokens (cross-attention with Sq != Sk), at
    the dense atol 1e-4 under ``_assert_close_to_jax``'s rule."""
    jcfg, _, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    cfg64 = cfg.replace(dtype="float64")
    frames, tokens = _inputs(cfg, 2, n_frames, n_tokens, seed=1)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens, jnp.int32)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    params, params64 = _carried(cfg), _carried(cfg64)

    enc = encdec.encode(params, tf, cfg)
    assert enc.shape == (2, n_frames, cfg.d_model)
    assert enc.dtype == torch.float32
    _assert_close_to_jax(enc.numpy(), jencdec.encode(jparams, jf, jcfg),
                         encdec.encode(params64, tf, cfg64).numpy())
    got = encdec.forward(params, tf, tt, cfg)
    assert got.shape == (2, n_tokens, cfg.vocab)
    assert got.dtype == torch.float32
    _assert_close_to_jax(got.numpy(), jencdec.forward(jparams, jf, jt, jcfg),
                         encdec.forward(params64, tf, tt, cfg64).numpy())


def test_train_step_matches_jax():
    """One train step on the data pipeline's tokens and stub frames,
    under the dense bounds of ROADMAP §C: the loss within 1e-5
    relative; each gradient leaf within atol 1e-5 and the grad-norm
    within 1e-5 relative, each plus twice the reference's own error
    against the port's f64 gradients (which must lie within 1e-2
    relative of the reference's); the port's train step reports that
    loss within 1e-5 and that grad-norm within 3e-4 relative.  Every
    encoder leaf gets a nonzero gradient: the decoder's cross-attention
    carries it back through ``enc_out``.  The cross-attention's key bias
    has none in exact arithmetic (no rope there: q . b_k is the same at
    every key, and the softmax cancels it), so its leaf has no scale for
    the relative same-function check; its f64 gradient must vanish
    instead, and the atol holds it."""
    jcfg, _, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    nb = jax_make_data(jcfg, 32, 4, seed=5).batch_at(2)
    assert nb["frames"].shape == (4, 32, cfg.d_model)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    params = _carried(cfg)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    loss, grads = compute_grads(params, batch, cfg)
    cfg64 = cfg.replace(dtype="float64")
    _, exact = compute_grads(_carried(cfg64), batch, cfg64)
    assert _close(loss, jloss, 1e-5)
    exact_norm = float(global_norm(exact))
    norm_err = abs(float(jax_global_norm(jgrads)) - exact_norm) / exact_norm
    assert norm_err <= 1e-2
    assert _close(global_norm(grads), jax_global_norm(jgrads),
                  1e-5 + 2 * norm_err)
    top = max(float(e.abs().max()) for e in tree_leaves(exact))
    cancelled = grads["dec_layers"]["cross"]["wk"]["w_b"]
    for g, jg, e in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                        tree_leaves(exact)):
        jg, e = np.asarray(jg), e.numpy()
        jax_err = float(np.abs(jg - e).max())
        if g is cancelled:
            assert float(np.abs(e).max()) <= 1e-12 * top
        else:
            assert jax_err <= 1e-2 * float(np.abs(e).max()), jax_err
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-5 + 2 * jax_err,
                                   rtol=0)
    for g in tree_leaves(grads["enc_layers"]) + tree_leaves(
            grads["enc_norm"]):
        assert g.abs().max() > 0

    opt = adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    state, m = make_train_step(cfg, opt)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)), batch)
    assert _close(m["loss"], jloss, 1e-5)
    assert _close(m["grad_norm"], jax_global_norm(jgrads), 3e-4)
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))


def test_remat_checkpoints_each_layer_and_changes_no_number(monkeypatch):
    """``cfg.remat`` checkpoints each encoder layer and each decoder
    layer as one unit, as the reference's ``jax.checkpoint`` bodies:
    ``enc_layers + dec_layers`` checkpointed regions a forward, and the
    same loss and gradients, bit for bit, as without remat."""
    cfg = get_config(ARCH, reduced=True)
    params = encdec.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in make_data(cfg, 32, 2, seed=3).batch_at(0).items()}
    loss0, g0 = compute_grads(params, batch, cfg)
    regions = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        regions.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    loss1, g1 = compute_grads(params, batch, cfg.replace(remat=True))
    assert len(regions) == cfg.enc_layers + cfg.dec_layers
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_decode_step_with_zero_caches_matches_jax():
    """14 decode steps of 2 rows over the zero cross caches that
    ``init_caches`` gives (``ENC_LEN_DECODE`` frames, the reference's
    contract), against the reference's steps at the dense atol 1e-4 under
    ``_assert_close_to_jax``'s rule."""
    jcfg, _, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    cfg64 = cfg.replace(dtype="float64")
    params, params64 = _carried(cfg), _carried(cfg64)
    B, steps, max_seq = 2, 14, 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (steps, B, 1))
    caches = init_caches(cfg, B, max_seq)
    assert len(caches) == cfg.dec_layers
    for c in caches:
        assert set(c) == {"k", "v", "ck", "cv"}
        assert c["ck"].shape == (B, ENC_LEN_DECODE, cfg.n_kv_heads,
                                 cfg.head_dim)
        assert c["cv"].dtype == torch.float32 and not c["cv"].any()
    caches64 = init_caches(cfg64, B, max_seq)
    jcaches = jax_init_caches(jcfg, B, max_seq)
    for pos in range(steps):
        tok = torch.from_numpy(toks[pos])
        logits, caches = decode_step(params, caches, tok, pos, cfg)
        exact, caches64 = decode_step(params64, caches64, tok, pos, cfg64)
        jlogits, jcaches = jax_decode_step(
            jparams, jcaches, jnp.asarray(toks[pos], jnp.int32), pos, jcfg)
        assert logits.shape == (B, cfg.vocab)
        _assert_close_to_jax(logits.numpy(), jlogits, exact.numpy())


def test_generate_streams_equal_jax():
    """``generate()`` of 3 prompts of 5 tokens and 12 new ones over zero
    cross caches: the port's greedy streams equal the reference's."""
    jcfg, _, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (3, 5))
    got = generate(_carried(cfg), cfg, prompt, 12)
    want = jserve.generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32), 12)
    assert got.shape == (3, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_over_encoder_caches_equals_forward():
    """The caller's contract: ``ck`` / ``cv`` written from the encoder's
    output over ``ENC_LEN_DECODE`` seeded frames, in both packages.  In
    each, 12 teacher-forced decode steps equal ``forward``'s logits at
    every position within the reference's own atol 2e-3
    (``tests/test_models.py::test_decode_consistent_with_forward``), and
    the port's decode logits equal the reference's under the dense
    decode bound (``_assert_close_to_jax``)."""
    jcfg, _, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    cfg64 = cfg.replace(dtype="float64")
    frames, tokens = _inputs(cfg, 1, ENC_LEN_DECODE, 12, seed=4)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(tokens)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens, jnp.int32)

    def port(cfg):
        params = _carried(cfg)
        enc_out = encdec.encode(params, tf, cfg)
        full = encdec.decode_train(params, tt, enc_out, cfg)
        caches = smoke.fill_cross(
            cfg, lm._unstack(params["dec_layers"], cfg.dec_layers), enc_out,
            init_caches(cfg, 1, 12), apply_dense)
        steps = []
        for pos in range(12):
            logits, caches = decode_step(params, caches,
                                         tt[:, pos:pos + 1], pos, cfg)
            steps.append(logits)
        return full, torch.stack(steps, 1)

    jenc = jencdec.encode(jparams, jf, jcfg)
    jfull = jencdec.decode_train(jparams, jt, jenc, jcfg)
    jlayers = [jax.tree.map(lambda a: a[li], jparams["dec_layers"])
               for li in range(jcfg.dec_layers)]
    jcaches = smoke.fill_cross(jcfg, jlayers, jenc,
                               jax_init_caches(jcfg, 1, 12), jax_apply_dense)
    jsteps = []
    for pos in range(12):
        logits, jcaches = jax_decode_step(jparams, jcaches,
                                          jt[:, pos:pos + 1], pos, jcfg)
        jsteps.append(np.asarray(logits))
    jsteps = np.stack(jsteps, 1)
    np.testing.assert_allclose(jsteps, np.asarray(jfull), atol=2e-3)

    full, steps = port(cfg)
    _, exact = port(cfg64)
    torch.testing.assert_close(steps, full, atol=2e-3, rtol=0)
    _assert_close_to_jax(steps.numpy(), jsteps, exact.numpy())


def test_serving_refuses_encdec_as_the_reference_does():
    """``ServeEngine`` and paged serving refuse the encoder-decoder, as
    the reference's do, and ``launch.serve`` exits before building
    anything; ``lm``'s model refuses it, naming ``models.encdec``."""
    cfg = get_config(ARCH, reduced=True)
    jcfg, _, _ = _jax_model()
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        jserve.ServeEngine(jcfg)
    with pytest.raises(ValueError,
                       match="paged serving does not support family"):
        paged_cache_kinds(cfg)
    with pytest.raises(SystemExit, match="encoder-decoder"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    for fn in (lm.model_spec, lambda c: lm.forward({}, None, c)):
        with pytest.raises(ValueError, match="models.encdec"):
            fn(cfg)
