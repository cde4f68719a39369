"""The GSPMD path of the families beyond the dense and moe steps, and
``seq_parallel`` without a mesh.

``seq_parallel`` without a mesh (or without a ``model`` axis) changes
nothing in the reference (``repro.models.lm._sp_constraint``); the port
raised on it (ROADMAP §C), and now computes the reference's logits.
One GSPMD step each of reduced gemma3-1b (one KV head, which ``model``
2 splits mid-head, so the blocks gather it and shard the query heads),
mamba2-1.3b (no tensor-parallel body: computed replicated over
``model``) and whisper-large-v3 (the encoder-decoder, likewise) on
(data=2, model=2), over 4 gloo ranks (``tests/torch_gspmd_ranks.py``),
held against the reference's ``make_train_step(mesh=...)`` on an
``AxisType.Auto`` mesh (``tests/gspmd_reference.py``) at the dense
train-step bounds of ROADMAP §C."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gspmd_reference as gref
import torch_gspmd_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import compute_grads

RANK_DEADLINE_S = 240
# the reference's f32 logits must lie this close to the port's f64 ones
SAME_FUNCTION_ATOL = 1e-3
# ROADMAP §C: the dense rule, and the moe rule for the moe family
FACTOR = {"stablelm-3b": 2, "olmoe-1b-7b": 3}


@pytest.mark.parametrize("arch", sorted(FACTOR))
def test_seq_parallel_without_a_mesh_matches_reference(arch):
    """f32 logits of (2, 64) tokens of reduced ``arch`` with
    ``seq_parallel=True`` and no mesh: the reference's forward runs them
    as without it; the port's equal its own without ``seq_parallel``
    exactly, and lie within atol 1e-4 plus ``FACTOR`` times the
    reference's error against the port's f64 evaluation of the reference
    (the forward-logits bounds of ROADMAP §C)."""
    jcfg = jax_get_config(arch, reduced=True).replace(seq_parallel=True)
    jparams = jax.tree.map(np.asarray,
                           jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    cfg = get_config(arch, reduced=True).replace(seq_parallel=True)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
    want = np.asarray(jlm.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                  jcfg), np.float64)
    params = params_from_jax(jparams, cfg)
    got = lm.forward(params, torch.from_numpy(tokens), cfg)
    plain = lm.forward(params, torch.from_numpy(tokens),
                       cfg.replace(seq_parallel=False))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    cfg64 = cfg.replace(dtype="float64")
    exact = lm.forward(params_from_jax(jparams, cfg64),
                       torch.from_numpy(tokens), cfg64).numpy()
    jax_err = float(np.abs(want - exact).max())
    assert jax_err <= SAME_FUNCTION_ATOL, jax_err
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 + FACTOR[arch] * jax_err)


ARCHS = ["gemma3-1b", "mamba2-1.3b", "whisper-large-v3"]
# test_train_step_matches_jax's batch: seq 32 x 4 of seed 5, batch 2
DATA = dict(seq=32, batch=4, seed=5, first=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """Each family's reference step on (data=2, model=2), then the port's
    on 4 ranks from the reference's parameters, one world for the file;
    and the port's mesh-less f64 gradients, the yardstick."""
    d = tmp_path_factory.mktemp("gspmd_model")
    ref = gref.run_reference(subproc, d, [
        dict(name=a, arch=a, mesh=dict(model=2), **DATA) for a in ARCHS])
    batches, cases = {}, {}
    for a in ARCHS:
        batches[a] = jax_make_data(jax_get_config(a, reduced=True),
                                   DATA["seq"], DATA["batch"],
                                   DATA["seed"]).batch_at(DATA["first"])
        cases[a] = dict(arch=a, mesh_kw=dict(model=2),
                        params=gref.params_of(ref[a]), batches=[batches[a]])
    run_ranks(ranks.gspmd_steps, 4, str(d), "steps", cases,
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    port = torch.load(d / "steps.pt", weights_only=False)
    exact = {}
    for a in ARCHS:
        cfg64 = get_config(a, reduced=True).replace(dtype="float64")
        _, g = compute_grads(
            params_from_jax(ranks.unflat(gref.params_of(ref[a])), cfg64),
            {k: torch.from_numpy(v) for k, v in batches[a].items()}, cfg64)
        exact[a] = {k: v.numpy() for k, v in ranks.flat(g)}
    return ref, port, exact


# The dense rule (twice the reference's error) for mamba2 and whisper;
# gemma3 takes the moe rule's GEMM_FACTOR (ROADMAP §C): the reference's
# sharded step rounds its gradients less than its mesh-less step does
# (embed/table 2.2e-5 from f64, against 4.1e-5), the port's GSPMD step as
# much as the port's mesh-less one (6.7e-5 against 6.5e-5), so the
# port's GEMM rounding is up to 3x the sharded reference's
STEP_FACTOR = {"gemma3-1b": 3, "mamba2-1.3b": 2, "whisper-large-v3": 2}


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_of_other_families_matches_reference(runs, arch):
    """One step on (data=2, model=2) from the reference's parameters
    (AdamW at b1 = 0): the loss within 1e-5 relative, each gradient
    within 1e-5 plus ``STEP_FACTOR`` times the reference's error against
    the f64 gradient, the grad-norm within 3e-4 relative plus that
    factor times its error, the parameters after the step as those
    bounds allow (``gspmd_reference.hold_step``)."""
    ref, port, exact = runs
    assert port[arch]["mesh"] == eval(str(ref[arch]["mesh"]))
    gref.hold_step(port[arch], ref[arch], exact[arch],
                   factor=STEP_FACTOR[arch])
