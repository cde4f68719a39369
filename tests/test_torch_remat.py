"""``remat_policy="dots"`` in the port (``models/lm.py::_remat``), the
reference's ``jax.checkpoint_policies.dots_saveable``, on the CPU at
reduced widths with ``remat=True``.

The policy saves what the matrix products return and recomputes the
rest, so it computes the function of ``"nothing"``: the dense, moe and
ssm families give the same loss and gradients bit for bit, held also
against the reference's own ``dots_saveable`` step at ROADMAP §C's
bounds (dense and ssm twice the reference's error against the port's
f64 gradients, moe ``GEMM_FACTOR`` times it).  The hybrid's groups and
the encoder-decoder's layers checkpoint with ``nothing_saveable``
whatever the config says, in the reference and in the port.  The
dry run's counter shows that no forward product runs again in the
backward pass, and the model kernels' autograd Functions, routed on
CPU tensors here, show their rule: K2 and K6 (and K7) run once a layer,
K1 as often as under ``"nothing"``."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.train.step import loss_fn as jax_loss_fn
from repro.utils.tree import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_data
from repro_torch.models import for_config
from repro_torch.models.convert import params_from_jax
from repro_torch.train import compute_grads
from repro_torch.utils.tree import global_norm, tree_leaves

# the reference's error against the port's f64 gradients, times this, is
# the room a leaf and the grad-norm have (ROADMAP §C)
FACTORS = {"stablelm-3b": 2, "mamba2-1.3b": 2, "olmoe-1b-7b": 3}


def _configs(arch, policy):
    over = dict(remat=True, remat_policy=policy)
    return (get_config(arch, reduced=True).replace(**over),
            jax_get_config(arch, reduced=True).replace(**over))


def _grads(arch, params, batch, policy):
    cfg, _ = _configs(arch, policy)
    loss, grads = compute_grads(params, batch, cfg)
    return loss, tree_leaves(grads)


def _same(a, b):
    return torch.equal(a[0], b[0]) and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("arch", sorted(FACTORS))
def test_dots_equals_nothing_and_matches_reference(arch):
    """Batch 2 of seed 5 (32 x 4), from the reference's parameters:
    ``"dots"``'s loss and gradients equal ``"nothing"``'s exactly; against
    the reference's ``dots_saveable`` step the loss within 1e-5 relative,
    and each gradient leaf (atol 1e-5) and the grad-norm (1e-5 relative)
    within ``FACTORS[arch]`` times the reference's own error against the
    port's f64 gradients, which lies within 1e-2."""
    cfg, jcfg = _configs(arch, "dots")
    model = jencdec if jcfg.family == "encdec" else jlm
    jparams = model.init_model(jcfg, jax.random.PRNGKey(0))
    carried = jax.tree.map(np.asarray, jparams)
    nb = jax_make_data(jcfg, 32, 4, seed=5).batch_at(2)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    params = params_from_jax(carried, cfg)
    dots = _grads(arch, params, batch, "dots")
    assert _same(dots, _grads(arch, params, batch, "nothing"))

    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    cfg64 = cfg.replace(dtype="float64")
    _, exact = compute_grads(params_from_jax(carried, cfg64), batch, cfg64)
    factor = FACTORS[arch]
    loss, grads = dots
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    exact_norm = float(global_norm(exact))
    jnorm = float(jax_global_norm(jgrads))
    norm_err = abs(jnorm - exact_norm) / exact_norm
    assert norm_err <= 1e-2, norm_err
    norm = sum(float(torch.sum(g.double() ** 2)) for g in grads) ** 0.5
    assert abs(norm - jnorm) <= (1e-5 + factor * norm_err) * jnorm
    for g, jg, e in zip(grads, jax.tree.leaves(jgrads), tree_leaves(exact)):
        jg, e = np.asarray(jg), e.numpy()
        jax_err = float(np.abs(jg - e).max())
        assert jax_err <= 1e-2 * max(float(np.abs(e).max()), 1e-30), jax_err
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-5 + factor * jax_err, rtol=0)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "zamba2-2.7b"])
def test_dots_runs_and_equals_nothing_where_the_reference_ignores_it(arch):
    """The hybrid's groups and the encoder-decoder's layers recompute
    whole under either policy, as the reference's ``nothing_saveable``
    there: ``"dots"`` runs, and its loss and gradients equal
    ``"nothing"``'s exactly."""
    cfg, _ = _configs(arch, "dots")
    params = for_config(cfg).init_model(cfg, torch.Generator()
                                        .manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in make_data(cfg, 32, 2, seed=3).batch_at(0).items()}
    dots = _grads(arch, params, batch, "dots")
    assert torch.isfinite(dots[0])
    assert _same(dots, _grads(arch, params, batch, "nothing"))


def _product_flops(cfg, kind):
    """``launch.jcost``'s matrix-product flops of a ``kind`` cell of
    ``cfg`` at 2 x 128, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import jcost
    from repro_torch.launch.specs import cell
    with FakeTensorMode():
        fn, args = cell(cfg, kind, 128, 2)
        with jcost.counting() as mode:
            fn(*args)
    return mode.cost.matmul_flops


def test_dots_recomputes_no_forward_product():
    """Reduced stablelm-3b's train step at 1 and 2 layers, counted by the
    dry run's ``launch.jcost``: a layer's product flops (the slope) under
    ``"dots"`` equal those without remat, so no forward product runs
    again in the backward pass.  Under ``"nothing"`` the recompute adds
    the layer's forward products (the forward's slope) but the last, the
    down projection (2·B·S·d_ff·d), whose output no backward op reads:
    non-reentrant checkpointing stops recomputing once the saved tensors
    it needs are back, so ``"dots"`` saves 3/4 of ``"nothing"``'s
    products only where that last product is negligible."""
    base = get_config("stablelm-3b", reduced=True)

    def slope(kind, **over):
        at = {n: _product_flops(base.replace(n_layers=n, **over), kind)
              for n in (1, 2)}
        return at[2] - at[1]

    dots = slope("train", remat=True, remat_policy="dots")
    nothing = slope("train", remat=True, remat_policy="nothing")
    assert dots == slope("train", remat=False)
    down = 2 * 2 * 128 * base.d_ff * base.d_model
    assert nothing - dots == slope("prefill") - down, (nothing, dots)


@pytest.mark.parametrize("arch,kernels", [
    ("stablelm-3b", ("rmsnorm", "fused_ff", "flash_attention")),
    ("mamba2-1.3b", ("rmsnorm", "ssd_chunk"))])
def test_model_kernels_rule_under_dots(arch, kernels, monkeypatch):
    """The kernels' rule (``_remat``'s docstring), seen on the CPU with
    every ``kernels.ops`` call routed through its kernel's autograd
    Function (whose wrapper computes the plain version for CPU tensors):
    a step at L layers makes the wrapper calls of a launch, K1 4L + 1
    under both policies, K2, K6 and K7 L under ``"dots"`` (their outputs
    saved through the custom operators ``ops.PRODUCTS`` names) against
    2L under ``"nothing"``, with the same loss and gradients."""
    from repro_torch.kernels import flash_attention, fused_ff, ops, rmsnorm
    from repro_torch.kernels import ssd
    calls = collections.Counter()
    for mod, name in ((rmsnorm, "rmsnorm"), (fused_ff, "fused_ff"),
                      (flash_attention, "flash_attention"),
                      (ssd, "ssd_chunk")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(ops, "_use_ref", lambda impl, name, *t: False)
    cfg, _ = _configs(arch, "dots")
    L = cfg.n_layers
    params = for_config(cfg).init_model(cfg, torch.Generator()
                                        .manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in make_data(cfg, 32, 2, seed=3).batch_at(0).items()}
    seen = {}
    for policy in ("nothing", "dots"):
        calls.clear()
        seen[policy] = _grads(arch, params, batch, policy)
        per_layer = 1 if policy == "dots" else 2
        want = {k: (4 * L + 1 if k == "rmsnorm" else per_layer * L)
                for k in kernels}
        assert dict(calls) == want, (policy, dict(calls), want)
    assert _same(seen["dots"], seen["nothing"])
