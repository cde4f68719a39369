"""The GSPMD step's collectives and MoE's expert-parallel dispatch on the
CPU, over 4 gloo ranks spawned by ``repro_torch.launch.mesh.run_ranks``
(``tests/torch_gspmd_ranks.py``), held against the reference run once
per file in a subprocess with 4 host devices, an ``AxisType.Auto`` mesh
and ``jax.set_mesh``: ``all_gather``, ``psum_scatter`` and
``all_to_all`` forward and gradient against JAX's own collectives and
their transposes under ``shard_map``; ``apply_moe_ep`` and
``apply_moe_ep_replicated`` on (data=2, model=2) against the
reference's, with the reference test's layer
(``tests/test_dist.py::test_moe_ep_matches_dense``) at its capacity
factor 8.0 (no drops) and at the config's 1.25 (drops); the
vocabulary-parallel loss and lookup against the port's mesh-less
ones."""

import numpy as np
import pytest
import torch

import torch_gspmd_ranks as ranks
from repro_torch.launch.mesh import run_ranks
from repro_torch.nn import moe

RANK_DEADLINE_S = 180

_REF = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro import nn
from repro.nn.core import init_params
from repro.nn.moe import (_pack_dispatch, apply_moe_ep,
                          apply_moe_ep_replicated, router_probs)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
io = dict(np.load("IN"))
out = {}
ops = {
    "gather_tiled": lambda x: jax.lax.all_gather(x, "model", axis=1,
                                                 tiled=True),
    "gather_stacked": lambda x: jax.lax.all_gather(x, "data", axis=0),
    "psum_scatter": lambda x: jax.lax.psum_scatter(
        x, "model", scatter_dimension=1, tiled=True),
    "all_to_all": lambda x: jax.lax.all_to_all(x, "model", 0, 0),
}
with jax.set_mesh(mesh):
    for name, op in ops.items():
        fn = jax.shard_map(lambda xb: op(xb[0])[None], mesh=mesh,
                           in_specs=P(("data", "model")),
                           out_specs=P(("data", "model")), check_vma=False)
        X, C = jnp.asarray(io["x_" + name]), jnp.asarray(io["c_" + name])
        y, vjp = jax.vjp(fn, X)
        out["y_" + name] = np.asarray(y)
        out["g_" + name] = np.asarray(vjp(C)[0])
    for cf in (8.0, 1.25):
        cfg = nn.MoEConfig(n_experts=8, top_k=2, d_model=32, d_ff=64,
                           capacity_factor=cf)
        p = init_params(nn.moe_spec(cfg), jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32))
        tag = f"cf{cf}"
        for k, v in (("router", p["router"]["w"]),
                     ("gate", p["experts"]["gate"]),
                     ("up", p["experts"]["up"]),
                     ("down", p["experts"]["down"])):
            out[f"{tag}_p_{k}"] = np.asarray(v)
        out[tag + "_x"] = np.asarray(x)
        out[tag + "_dense"] = np.asarray(nn.apply_moe_dense(p, x, cfg))
        out[tag + "_ep"] = np.asarray(apply_moe_ep(p, x, cfg, mesh))
        out[tag + "_rep"] = np.asarray(apply_moe_ep_replicated(p, x, cfg,
                                                               mesh))
        for i in range(2):
            for j in range(2):
                xs = x[2 * i:2 * i + 2, 4 * j:4 * j + 4].reshape(8, 32)
                g, idx, _ = router_probs(p, xs, cfg)
                cap = max(int(8 * cfg.top_k * cfg.capacity_factor
                              // cfg.n_experts), 4)
                out[f"{tag}_slots_{i}{j}"] = np.asarray(
                    _pack_dispatch(xs, g, idx, cfg.n_experts, cap)[1])
np.savez("OUT", **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    """The reference's collectives on every rank's inputs, and its MoE
    layers; run once for the file."""
    d = tmp_path_factory.mktemp("gspmd_ref")
    io = {}
    for name, (_, shape) in ranks.COLLECTIVE_CASES.items():
        xs = [ranks.rank_inputs(i, shape)[0] for i in range(4)]
        y_shape = _out_shape(name, shape)
        cs = [ranks.rank_inputs(i + 10, y_shape)[0] for i in range(4)]
        io["x_" + name], io["c_" + name] = np.stack(xs), np.stack(cs)
    np.savez(d / "in.npz", **io)
    subproc(_REF.replace("IN", str(d / "in.npz"))
            .replace("OUT", str(d / "out.npz")), n_devices=4)
    return dict(np.load(d / "out.npz"))


def _out_shape(name, shape):
    if name == "gather_tiled":
        return (shape[0], 2 * shape[1], shape[2])
    if name == "gather_stacked":
        return (2,) + shape
    if name == "psum_scatter":
        return (shape[0], shape[1] // 2, shape[2])
    return shape


def _spawn(tmp_path, fn, *args):
    run_ranks(fn, 4, str(tmp_path), *args,
              init_method=f"file://{tmp_path}/pg_{fn.__name__}",
              timeout_s=RANK_DEADLINE_S)
    return [torch.load(tmp_path / f"{fn.__name__}_{r}.pt",
                       weights_only=False) for r in range(4)]


def test_collectives_match_jax_and_its_transposes(tmp_path, reference):
    """On (data=2, model=2), rank (d, m) holds x_{2d+m} and weighs its
    output by c_{2d+m}: each collective's output, and the gradient of the
    summed loss for its input, equal ``jax.lax``'s inside ``shard_map``
    and ``jax.vjp`` of it (the transposes: an all-gather's is a
    psum_scatter, a psum_scatter's an all-gather, an all-to-all's the
    reverse all-to-all; the reference's MoE dispatch splits and concats
    on dimension 0, the case held here), within 1e-6 (sums of at
    most 2 f32 terms)."""
    outs = _spawn(tmp_path, ranks.collectives)
    for o in outs:
        i = o["index"]
        for name in ranks.COLLECTIVE_CASES:
            y, g = o[name]
            np.testing.assert_allclose(y, reference["y_" + name][i],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} forward, index {i}")
            np.testing.assert_allclose(g, reference["g_" + name][i],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} gradient, index {i}")


def test_vocabulary_parallel_loss_and_lookup(tmp_path):
    """The GSPMD step's vocabulary-parallel pieces on (data=2, model=2),
    vocabulary 10 in blocks of 5: ``cross_entropy(..., vocab)`` on each
    rank's rows and columns gives its rows' mean NLL on both model ranks,
    and with the loss weighed as the step weighs it (model rank 0 alone)
    the psums' backward hands every rank its block of the whole loss's
    softmax gradient; ``lm.vocab_embed`` in each rank's block of the
    table gives the rows of the whole table, and each block's gradient,
    summed over the data ranks, is its rows' whole gradient.  Held to the
    port's mesh-less loss and lookup within 1e-6."""
    from repro_torch.train import cross_entropy
    gen = np.random.default_rng(3)
    logits = (4 * gen.standard_normal((4, 3, 10))).astype(np.float32)
    labels = gen.integers(0, 10, (4, 3)).astype(np.int64)
    table = gen.standard_normal((10, 6)).astype(np.float32)
    c = gen.standard_normal((4, 3, 6)).astype(np.float32)
    outs = _spawn(tmp_path, ranks.vocab_parallel, logits, labels, table, c)
    whole = torch.from_numpy(logits).requires_grad_()
    (g,) = torch.autograd.grad(
        cross_entropy(whole, torch.from_numpy(labels)), whole)
    tab = torch.from_numpy(table).requires_grad_()
    e = tab[torch.from_numpy(labels)]
    (gt,) = torch.autograd.grad((torch.from_numpy(c) * e).sum(), tab)
    dtable = np.zeros_like(table)
    for o in outs:
        d, m = o["coords"]["data"], o["coords"]["model"]
        rows, cols = slice(2 * d, 2 * d + 2), slice(5 * m, 5 * m + 5)
        want = float(cross_entropy(whole[rows].detach(),
                                   torch.from_numpy(labels[rows])))
        assert abs(o["loss"] - want) <= 1e-6 * abs(want), (o["loss"], want)
        np.testing.assert_allclose(o["dlogits"], g.numpy()[rows, :, cols],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(o["lookup"], e.detach().numpy()[rows],
                                   atol=1e-6, rtol=0)
        dtable[cols] += o["dtable"]
    np.testing.assert_allclose(dtable, gt.numpy(), atol=1e-6, rtol=0)


_MOE_KW = dict(n_experts=8, top_k=2, d_model=32, d_ff=64)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_ep_matches_reference(tmp_path, reference, cf):
    """The reference test's layer (8 experts, top 2, tokens (4, 8, 32)) on
    (data=2, model=2), each rank with its batch block and its 4 experts:
    ``apply_moe_ep``'s and ``apply_moe_ep_replicated``'s outputs within
    atol 2e-4 of the reference's (its test's bound); at capacity factor
    8.0 (no drops) both also within 2e-4 of the dense layer, at 1.25 the
    capacity of 4 drops slots and ``apply_moe_ep`` is held to the
    reference's EP output, not the dense one.  The slots each rank packs
    for its (batch, sequence) block equal the reference's
    ``_pack_dispatch`` on that block, exactly, and so do those of the
    one-process ``apply_moe_ep_plain``, whose output and gradients (for
    the tokens and each expert weight) the distributed layer's match
    within 1e-5."""
    tag = f"cf{cf}"
    p_np = {"/router/w": reference[tag + "_p_router"],
            **{f"/experts/{k}": reference[f"{tag}_p_{k}"]
               for k in ("gate", "up", "down")}}
    x_np = reference[tag + "_x"]
    c_np = np.random.default_rng(7).standard_normal(x_np.shape).astype(
        np.float32)
    outs = _spawn(tmp_path, ranks.moe_ep, p_np, x_np, c_np,
                  dict(_MOE_KW, capacity_factor=cf))
    cfg = moe.MoEConfig(**_MOE_KW, capacity_factor=cf)
    p = ranks.unflat({k: torch.from_numpy(v).requires_grad_()
                      for k, v in p_np.items()})
    x = torch.from_numpy(x_np).requires_grad_()
    plain, slots = moe.apply_moe_ep_plain(p, x, cfg, 2, 2)
    leaves = [x, *(v for _, v in ranks.flat(p))]
    plain_grads = torch.autograd.grad(
        (torch.from_numpy(c_np) * plain).sum(), leaves)
    dropped = 0
    for i in range(2):
        for j in range(2):
            want = reference[f"{tag}_slots_{i}{j}"]
            np.testing.assert_array_equal(slots[2 * i + j].numpy(), want)
            dropped += int((want == cfg.n_experts
                            * moe.capacity(cfg, 8)).sum())
    assert (dropped == 0) == (cf == 8.0), dropped
    np.testing.assert_allclose(plain.detach().numpy(), reference[tag + "_ep"],
                               atol=2e-4, rtol=0)
    for o in outs:
        d, m = o["coords"]["data"], o["coords"]["model"]
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(o["slots"],
                                      reference[f"{tag}_slots_{d}{m}"])
        np.testing.assert_allclose(o["ep"]["out"],
                                   reference[tag + "_ep"][rows],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(o["replicated"]["out"],
                                   reference[tag + "_rep"][rows],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(o["ep"]["out"],
                                   plain.detach().numpy()[rows],
                                   atol=1e-5, rtol=0)
        if cf == 8.0:
            for kind in ("ep", "replicated"):
                np.testing.assert_allclose(o[kind]["out"],
                                           reference[tag + "_dense"][rows],
                                           atol=2e-4, rtol=0)
    # gradients: a token's is the sum over the model ranks that hold its
    # batch block (each routes its own sequence block); an expert's lives
    # on the rank that holds it and sums over the data ranks
    by = {(o["coords"]["data"], o["coords"]["model"]): o["ep"] for o in outs}
    dx = np.concatenate([by[(d, 0)]["dx"] + by[(d, 1)]["dx"]
                         for d in range(2)])
    np.testing.assert_allclose(dx, plain_grads[0].numpy(), atol=1e-5,
                               rtol=0)
    for (path, _), want in zip(ranks.flat(p), plain_grads[1:]):
        if path.startswith("/router"):
            got = sum(o["dp"][path] for o in by.values())
        else:
            got = np.concatenate([by[(0, m)]["dp"][path]
                                  + by[(1, m)]["dp"][path]
                                  for m in range(2)])
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0,
                                   err_msg=path)


def test_staged_sums_and_shift(tmp_path):
    """The host-staged transport's small sums (an all-gather summed in the
    group's rank order, ``collectives.GATHER_SUM_BYTES``) equal
    ``all_reduce``'s within f32 rounding and are the same bits on every
    rank; a larger sum takes ``all_reduce``.  ``shift_down`` over
    (data, model) hands each combined index its successor's block and the
    last zeros."""
    outs = _spawn(tmp_path, ranks.staged_sums)
    for o in outs:
        for name, (plain, staged) in o["sums"].items():
            np.testing.assert_allclose(staged, plain, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_array_equal(staged, outs[0]["sums"][name][1])
        i = o["index"]
        want = (ranks.rank_inputs(i + 1, (3, 4))[0] if i < 3
                else np.zeros((3, 4), np.float32))
        np.testing.assert_array_equal(o["shifted"], want)
