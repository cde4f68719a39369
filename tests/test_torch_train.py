"""The port's training slice against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both frameworks; model parameters
are the JAX model's, carried across with ``params_from_jax``.  Checked:
``chunked_attention`` (GQA, window, q_offset, chunk < S); the forward
logits of reduced stablelm-3b, gemma3-1b (sliding windows) and
chameleon-34b (qk-norm); one train step's loss, grad-norm and per-leaf
gradients; AdamW, Adam, SGD-momentum and the four schedules; the data
pipeline; checkpoints crossing between the two ``Trainer``s; the
kill-and-resume replay; that training lowers the loss; and the launcher.
Tolerances are stated where they are used."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import lm as jlm
from repro.optim.adamw import apply_updates as jax_apply_updates
from repro.nn.attention import chunked_attention as jax_chunked_attention
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train.step import loss_fn as jax_loss_fn
from repro.utils.tree import global_norm as jax_global_norm
from repro_torch import optim
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_data
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.nn.attention import NO_WINDOW, chunked_attention
from repro_torch.train import (InjectedFailure, TrainConfig, Trainer,
                               compute_grads, make_train_step)
from repro_torch.train.step import TrainState
from repro_torch.utils.tree import global_norm, tree_leaves, tree_map

LOGIT_ATOL = 1e-4
SAME_FUNCTION_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _jax_params(arch):
    jcfg = jax_get_config(arch, reduced=True)
    return jcfg, jlm.init_model(jcfg, jax.random.PRNGKey(0))


def _port_params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


# ---------------------------------------------------------------------------
# attention and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset,sq", [
    (True, NO_WINDOW, 0, 64), (True, 20, 0, 64), (True, 20, 32, 32),
    (False, 24, 0, 64), (False, NO_WINDOW, 16, 48)])
def test_chunked_attention_matches_jax(causal, window, q_offset, sq):
    """8 query heads over 2 KV heads, Sk 64 in chunks of 16; atol 1e-5
    (f32 softmax sums of 64 terms in another order)."""
    rng = np.random.default_rng(sq + q_offset)
    q = rng.standard_normal((2, sq, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, chunk=16, q_offset=q_offset)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = jax_chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    assert got.shape == (2, sq, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-1b",
                                  "chameleon-34b"])
def test_forward_logits_match_jax(arch):
    """f32 logits of (2, 64) tokens.  Both are f32 evaluations of one
    function summed in other orders, so they differ by its f32 rounding
    error, which exceeds 1e-4 here (tied N(0, 1) embeddings put |logits|
    near 30; the reference's own f32 logits lie up to 6.6e-4 from an f64
    evaluation on reduced stablelm-3b).  So, as for the decode logits
    (``tests/test_torch_serve.py``), the bound is atol 1e-4 plus twice the
    reference's error against the port's f64 evaluation of the same
    parameters, which must itself lie within 1e-3 of the reference."""
    jcfg, jparams = _jax_params(arch)
    cfg = get_config(arch, reduced=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
    want = np.asarray(jlm.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                  jcfg))
    got = lm.forward(_port_params(jparams, cfg), torch.from_numpy(tokens),
                     cfg)
    cfg64 = cfg.replace(dtype="float64")
    exact = lm.forward(_port_params(jparams, cfg64),
                       torch.from_numpy(tokens), cfg64).numpy()
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == torch.float32
    jax_err = float(np.abs(want.astype(np.float64) - exact).max())
    assert jax_err <= SAME_FUNCTION_ATOL, jax_err
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=LOGIT_ATOL + 2 * jax_err, rtol=0)


def test_remat_changes_no_number():
    """``cfg.remat`` (per-layer ``torch.utils.checkpoint``) recomputes the
    layers in the backward pass: the same loss and gradients, bit for
    bit."""
    cfg = get_config("stablelm-3b", reduced=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in make_data(cfg, 32, 2, seed=3).batch_at(0).items()}
    loss0, g0 = compute_grads(params, batch, cfg)
    loss1, g1 = compute_grads(params, batch, cfg.replace(remat=True))
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step and the optimizer
# ---------------------------------------------------------------------------

def _close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_train_step_matches_jax(num_microbatches):
    """Loss within 1e-5 relative.  The gradients' f32 rounding error is
    far above 1e-5: the reference's own f32 gradients lie up to 1.9e-3
    from an f64 evaluation (through softmaxes of logits near 30), and its
    grad-norm 9.5e-5 relative.  So, as for the logits, each gradient leaf
    is held to atol 1e-5, and the grad-norm to 1e-5 relative, plus twice
    the reference's own error against the port's f64 gradients (which
    must lie within 1e-2 relative of the reference's); the train step's
    grad-norm metric to 3e-4 relative, three times that error.  (The
    parameters after the step are not compared entry by entry: a first
    Adam step moves an entry by lr * g / (|g| + 1e-8), which the rounding
    of a tiny g changes by a share of lr; ``test_optimizers_match_jax``
    holds the update itself to 1e-6 on fixed gradients.)"""
    jcfg, jparams = _jax_params("stablelm-3b")
    cfg = get_config("stablelm-3b", reduced=True)
    nb = jax_make_data(jcfg, 32, 4, seed=5).batch_at(2)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    params = _port_params(jparams, cfg)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    loss, grads = compute_grads(params, batch, cfg, num_microbatches)
    if num_microbatches == 1:
        cfg64 = cfg.replace(dtype="float64")
        _, exact = compute_grads(_port_params(jparams, cfg64), batch, cfg64)
        assert _close(loss, jloss, 1e-5)
        exact_norm = float(global_norm(exact))
        norm_err = abs(float(jax_global_norm(jgrads)) - exact_norm) \
            / exact_norm
        assert norm_err <= 1e-2
        assert _close(global_norm(grads), jax_global_norm(jgrads),
                      1e-5 + 2 * norm_err)
        for g, jg, e in zip(tree_leaves(grads), jax.tree.leaves(jgrads),
                            tree_leaves(exact)):
            jg, e = np.asarray(jg), e.numpy()
            jax_err = float(np.abs(jg - e).max())
            assert jax_err <= 1e-2 * float(np.abs(e).max()), jax_err
            np.testing.assert_allclose(g.numpy(), jg, atol=1e-5
                                       + 2 * jax_err, rtol=0)

    jopt = joptim.adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    opt = optim.adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    from repro.train.step import TrainState as JaxTrainState
    from repro.train.step import make_train_step as jax_make_train_step
    jstate = JaxTrainState(jparams, jopt.init(jparams),
                           jnp.zeros((), jnp.int32))
    jstate, jm = jax_make_train_step(jcfg, jopt,
                                     num_microbatches=num_microbatches)(
        jstate, jbatch)
    state = TrainState(params, opt.init(params), torch.zeros((),
                                                             dtype=torch.int32))
    state, m = make_train_step(cfg, opt,
                               num_microbatches=num_microbatches)(state,
                                                                  batch)
    assert _close(m["loss"], jm["loss"], 1e-5)
    assert _close(m["grad_norm"], jm["grad_norm"], 3e-4)
    assert int(m["step"]) == int(jm["step"]) == 1
    assert int(state.step) == int(state.opt_state.step) == 1
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))


def _fixed_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "b": rng.standard_normal((5,)).astype(dtype),
            "s": {"stack": rng.standard_normal((3, 4, 2)).astype(dtype)}}


_OPTIMIZERS = {   # name -> (optimizer factory, its arguments)
    "adamw": ("adamw", lambda o: (o.linear_warmup_cosine(0.01, 2, 10),),
              dict(weight_decay=0.1, max_grad_norm=1.0)),
    "adamw_nodecay": ("adamw", lambda o: (0.01,), dict(max_grad_norm=0.5)),
    "adam": ("adam", lambda o: (0.01,), {}),
    "sgd": ("sgd_momentum", lambda o: (0.01,), {}),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizers_match_jax(name):
    """Five updates on fixed arrays (gradients large enough to clip);
    updates, parameters and optimizer state within 1e-6."""
    fn, args, kw = _OPTIMIZERS[name]
    jopt = getattr(joptim, fn)(*args(joptim), **kw)
    topt = getattr(optim, fn)(*args(optim), **kw)
    rng = np.random.default_rng(9)
    p0 = _fixed_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = tree_map(lambda a: a * 3.0, _fixed_tree(rng))
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        jp, tp = jax_apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(tree_leaves((tp, ts)), jax.tree.leaves((jp, js))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (0.3,)), ("linear_schedule", (0.3, 40, 0.1)),
    ("cosine_schedule", (0.3, 40)), ("linear_warmup_cosine", (0.3, 7, 40))])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(joptim, name)(*args), getattr(optim, name)(*args)
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6, (step, float(got), want)


def test_tree_utilities_match_jax():
    """sum_squares / global_norm / clip_by_global_norm / param_count on a
    tree with bf16 and f32 leaves; f32 sums of 66 terms, rtol 1e-6."""
    from repro.utils import tree as jtree
    from repro_torch.utils import tree as ttree
    rng = np.random.default_rng(3)
    tree = _fixed_tree(rng)
    jt = jax.tree.map(jnp.asarray, tree)
    jt["w"] = jt["w"].astype(jnp.bfloat16)
    tt = tree_map(torch.from_numpy, tree)
    tt["w"] = tt["w"].to(torch.bfloat16)
    for name in ("sum_squares", "global_norm"):
        assert _close(getattr(ttree, name)(tt), getattr(jtree, name)(jt),
                      1e-6)
    for max_norm in (1.0, 100.0):
        (got, gn), (want, wn) = (ttree.clip_by_global_norm(tt, max_norm),
                                 jtree.clip_by_global_norm(jt, max_norm))
        assert _close(gn, wn, 1e-6)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert ttree.param_count(tt) == jtree.param_count(jt) == 59


def test_data_batches_bit_identical():
    jcfg, cfg = (jax_get_config("stablelm-3b", reduced=True),
                 get_config("stablelm-3b", reduced=True))
    jd, td = jax_make_data(jcfg, 24, 3, seed=7), make_data(cfg, 24, 3, seed=7)
    for step in (0, 1, 17, 123):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


# ---------------------------------------------------------------------------
# checkpoints and the training loop
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_keeps_dtypes(tmp_path):
    tree = TrainState({"a": torch.arange(10.0),
                       "b": {"c": torch.randn(3, 4).to(torch.bfloat16)}},
                      None, torch.tensor(7, dtype=torch.int32))
    checkpoint.save(str(tmp_path), 7, tree)
    back, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 7 and isinstance(back, TrainState) and back.ef is None
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), {"only": torch.zeros(1)})


BASE = dict(seq_len=16, global_batch=2, lr=1e-3, warmup=2)


def test_checkpoints_cross_between_the_trainers(tmp_path):
    """A checkpoint the JAX ``Trainer`` wrote (reduced stablelm-3b, after
    3 steps) restores into the port's ``Trainer``, whose next step's loss
    and grad-norm equal the resumed JAX ``Trainer``'s within 1e-5
    relative; and the port's checkpoint of the step after restores into
    the JAX package bit for bit."""
    jcfg = jax_get_config("stablelm-3b", reduced=True)
    cfg = get_config("stablelm-3b", reduced=True)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxTrainer(jcfg, JaxTrainConfig(steps=3, ckpt_dir=jdir, **BASE)).run()
    shutil.copytree(jdir, tdir)
    jlog = JaxTrainer(jcfg, JaxTrainConfig(steps=4, ckpt_dir=jdir,
                                           **BASE)).run()
    port = Trainer(cfg, TrainConfig(steps=4, ckpt_dir=tdir, **BASE),
                   device="cpu")
    assert port.start_step == 3
    tlog = port.run()
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog] == [3]
    assert _close(tlog[0]["loss"], jlog[0]["loss"], 1e-5)
    assert _close(tlog[0]["grad_norm"], jlog[0]["grad_norm"], 1e-5)

    like = JaxTrainer(jcfg, JaxTrainConfig(steps=4, **BASE)).state
    state, step = jckpt.restore(tdir, like)
    assert step == 4
    for a, b in zip(jax.tree.leaves(state), tree_leaves(port.state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_failure_injection_and_bitwise_resume(tmp_path):
    """Kill at step 14, restart from the step-10 checkpoint: the losses
    replay the uninterrupted run's (``tests/test_data_ckpt_ft.py``)."""
    cfg = get_config("stablelm-3b", reduced=True)
    base = dict(steps=20, ckpt_every=10, **BASE)
    ref = Trainer(cfg, TrainConfig(**base), device="cpu").run()
    ckdir = str(tmp_path / "ck")
    failing = Trainer(cfg, TrainConfig(**base, ckpt_dir=ckdir,
                                       fail_at_step=14), device="cpu")
    with pytest.raises(InjectedFailure):
        failing.run()
    assert checkpoint.latest_step(ckdir) == 10
    resumed = Trainer(cfg, TrainConfig(**base, ckpt_dir=ckdir), device="cpu")
    assert resumed.start_step == 10
    ref_loss = {row["step"]: row["loss"] for row in ref}
    for row in resumed.run():
        assert row["loss"] == pytest.approx(ref_loss[row["step"]],
                                            rel=1e-5), row["step"]


def test_training_lowers_the_loss():
    """``tests/test_models.py::test_loss_decreases_stablelm`` on the port."""
    cfg = get_config("stablelm-3b", reduced=True)
    tcfg = TrainConfig(steps=25, seq_len=32, global_batch=4, lr=5e-3,
                       warmup=2)
    events = []
    log = Trainer(cfg, tcfg, device="cpu",
                  straggler_hook=lambda s, dt: events.append(s)).run()
    assert log[-1]["loss"] < log[0]["loss"]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in log)


def test_launcher(capsys):
    launch_train.main(["--device", "cpu", "--steps", "3", "--seq-len", "16",
                       "--global-batch", "2"])
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 3 and "[train] final loss" in out
    # a mesh runs one process per rank: outside torchrun it says so, for
    # the pipeline step and the GSPMD step (a mesh without --pipe >= 2)
    for flags in (["--pipe", "2"], ["--model", "2"], ["--pods", "2"]):
        with pytest.raises(RuntimeError, match="torchrun"):
            launch_train.main(["--device", "cpu", *flags])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.main(["--steps", "1"])


def test_launcher_trains_the_ssm_family(capsys):
    """``--arch mamba2-1.3b``, ``--arch zamba2-2.7b`` (hybrid) and
    ``--arch whisper-large-v3`` (encdec, over the pipeline's stub frames)
    train the reduced config on the CPU."""
    for arch in ("mamba2-1.3b", "zamba2-2.7b", "whisper-large-v3"):
        launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                           "3", "--seq-len", "16", "--global-batch", "2"])
        out = capsys.readouterr().out
        assert out.count("[train] step=") == 3 and "[train] final loss" in out
