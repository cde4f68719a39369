"""The port's hybrid family (zamba2-2.7b, reduced) against the JAX
package, on the CPU: the parameter tree crossing with
``params_from_jax``, the forward logits, one train step, remat grouping
each run of Mamba-2 layers with the shared block it feeds, and decode
against the parallel forward.  Inputs come from numpy seeds and go to
both frameworks; tolerances are stated where they are used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import lm as jlm
from repro.train.step import loss_fn as jax_loss_fn
from repro.utils.tree import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_data
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.serve import decode_step, init_caches
from repro_torch.train import compute_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.utils.tree import global_norm, tree_leaves

ARCH = "zamba2-2.7b"

_MODEL = {}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _jax_model():
    if not _MODEL:
        jcfg = jax_get_config(ARCH, reduced=True)
        _MODEL["jax"] = (jcfg, jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return _MODEL["jax"]


def _carried(cfg):
    _, jparams = _jax_model()
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


def test_params_from_jax_takes_the_hybrid_tree():
    """The JAX tree (stacked Mamba-2 layers and one unstacked shared
    block) crosses leaf for leaf; a tree without the shared block, or
    with a misshapen shared leaf, is refused."""
    cfg = get_config(ARCH, reduced=True)
    _, jparams = _jax_model()
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(tree, cfg)
    assert set(params) == {"embed", "final_norm", "layers", "shared_block"}
    assert params["layers"]["ssm"]["in_proj"]["w"].shape[0] == cfg.n_layers
    for got, want in zip(tree_leaves(params), jax.tree.leaves(tree)):
        assert np.array_equal(got.numpy(), want)
    bad = dict(tree)
    del bad["shared_block"]
    with pytest.raises(ValueError, match="root"):
        params_from_jax(bad, cfg)
    bad = jax.tree.map(np.asarray, jparams)
    bad["shared_block"]["ln2"]["scale"] = bad["shared_block"]["ln2"][
        "scale"][:-1]
    with pytest.raises(ValueError, match="shared_block/ln2/scale"):
        params_from_jax(bad, cfg)


def test_forward_logits_match_jax():
    """f32 logits of (2, 64) tokens (two Mamba-2 groups, each followed by
    the shared attention block, attention in chunks of 32) at the dense
    bound (ROADMAP §C): atol 1e-4 plus twice the reference's error
    against the port's f64 evaluation, which must lie within 1e-3 of
    the reference."""
    jcfg, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
    want = np.asarray(jlm.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                  jcfg))
    got = lm.forward(_carried(cfg), torch.from_numpy(tokens), cfg)
    cfg64 = cfg.replace(dtype="float64")
    exact = lm.forward(_carried(cfg64), torch.from_numpy(tokens),
                       cfg64).numpy()
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == torch.float32
    jax_err = float(np.abs(want.astype(np.float64) - exact).max())
    assert jax_err <= 1e-3, jax_err
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-4 + 2 * jax_err, rtol=0)


def test_train_step_matches_jax():
    """One train step under the bounds of ROADMAP §C (as
    ``tests/test_torch_ssm.py::test_train_step_matches_jax``): the loss
    within 1e-5 relative; each gradient leaf within atol 1e-5 and the
    grad-norm within 1e-5 relative, each plus twice the reference's own
    error against the port's f64 gradients; the port's train step
    reports that loss within 1e-5 and that grad-norm within 3e-4
    relative.  The shared block's gradient sums its two applications."""
    jcfg, jparams = _jax_model()
    cfg = get_config(ARCH, reduced=True)
    nb = jax_make_data(jcfg, 32, 4, seed=5).batch_at(2)
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
    for g, jg, e in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                        tree_leaves(exact)):
        jg, e = np.asarray(jg), e.numpy()
        jax_err = float(np.abs(jg - e).max())
        assert jax_err <= 1e-2 * float(np.abs(e).max()), jax_err
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-5 + 2 * jax_err,
                                   rtol=0)

    opt = adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    state, m = make_train_step(cfg, opt)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)), batch)
    assert _close(m["loss"], jloss, 1e-5)
    assert _close(m["grad_norm"], jax_global_norm(jgrads), 3e-4)
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))


def test_remat_checkpoints_groups_and_changes_no_number(monkeypatch):
    """``cfg.remat`` checkpoints each group (``shared_attn_every``
    Mamba-2 layers and the shared block) as one unit, as the reference's
    ``jax.checkpoint(group_fn)``: ``n_layers / shared_attn_every``
    checkpointed regions a forward, and the same loss and gradients, bit
    for bit, as without remat."""
    cfg = get_config(ARCH, reduced=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
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
    assert len(regions) == cfg.n_layers // cfg.shared_attn_every
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_decode_equals_parallel():
    """12 one-token ``decode_step``s (recurrent SSM steps, the shared
    block attending over its cache) equal the parallel forward's logits.
    In f64 they are one function: within 1e-9 (measured 7e-14).  In f32
    ``tests/test_torch_ssm.py::test_ssm_decode_equals_parallel``'s atol
    3e-5 lies below the f32 rounding error of this model (|logits| up to
    32; the parallel f32 logits lie 5.9e-5 from f64, the decoded 1.5e-4,
    and the two 1.1e-4 apart), so by ROADMAP §C's rule the bound is 3e-5
    plus twice the parallel path's own error against f64."""
    cfg = get_config(ARCH, reduced=True)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))

    def both(cfg):
        params = _carried(cfg)
        caches = init_caches(cfg, 2, 16)
        got = []
        for t in range(12):
            logits, caches = decode_step(params, caches,
                                         tokens[:, t:t + 1], t, cfg)
            got.append(logits)
        return (lm.forward(params, tokens, cfg).detach().double(),
                torch.stack(got, 1).double())

    par64, dec64 = both(cfg.replace(dtype="float64"))
    torch.testing.assert_close(dec64, par64, atol=1e-9, rtol=0)
    par, dec = both(cfg)
    f32_err = (par - par64).abs().max().item()
    assert f32_err <= 1e-3, f32_err
    torch.testing.assert_close(dec, par, atol=3e-5 + 2 * f32_err, rtol=0)
