"""Rank bodies of the port's GSPMD tests (``tests/test_torch_gspmd*.py``).

Each function runs in one process of a world of 4 that
``repro_torch.launch.mesh.run_ranks`` spawns on the CPU (gloo), and
writes what it measured under ``out_dir`` for the test to check.  This
module imports torch and the port only, so that the spawned ranks load
no jax."""

import os

import numpy as np
import torch


def _save(out_dir, name, obj):
    path = os.path.join(out_dir, name)
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def unflat(pairs):
    """The nested dict of ``flat``'s (path, leaf) pairs."""
    out = {}
    for path, leaf in pairs.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def rank_inputs(index, shape):
    """Rank ``index``'s input and loss weight (the test draws the same)."""
    gen = np.random.default_rng(index)
    return (gen.standard_normal(shape).astype(np.float32),
            gen.standard_normal(shape).astype(np.float32))


# each case of :func:`_collective`: (mesh axis, input shape)
COLLECTIVE_CASES = {
    "gather_tiled": ("model", (3, 2, 5)),
    "gather_stacked": ("data", (3, 2, 5)),
    "psum_scatter": ("model", (3, 4, 5)),
    "all_to_all": ("model", (2, 3, 5)),
}


def _collective(name, x, axis):
    from repro_torch.dist import collectives as col
    if name == "gather_tiled":
        return col.all_gather(x, axis, 1, tiled=True)
    if name == "gather_stacked":
        return col.all_gather(x, axis, 0)
    if name == "psum_scatter":
        return col.psum_scatter(x, axis, 1)
    return col.all_to_all(x, axis, 0, 0)


def collectives(rank, out_dir):
    """The GSPMD collectives on a (data=2, model=2) mesh: rank (d, m)
    draws its input and loss weight from ``2 * d + m`` and saves each
    case's output and its input's gradient."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2, device="cpu")
    index = 2 * mesh.coords["data"] + mesh.coords["model"]
    out = {"index": index}
    for name, (axis, shape) in COLLECTIVE_CASES.items():
        x, c = rank_inputs(index, shape)
        x = torch.from_numpy(x).requires_grad_()
        y = _collective(name, x, mesh.axis(axis))
        c = torch.from_numpy(rank_inputs(index + 10, tuple(y.shape))[0])
        (g,) = torch.autograd.grad((c * y).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    _save(out_dir, f"collectives_{rank}.pt", out)


def vocab_parallel(rank, out_dir, logits_np, labels_np, table_np, c_np):
    """The GSPMD step's vocabulary-parallel loss and lookup on a (data=2,
    model=2) mesh: rank (d, m) holds rows 2d, 2d + 1 of the global
    logits, labels and tokens, and block m of the vocabulary (logits'
    columns, the table's rows).  It saves its loss as the step weighs it
    (1 / data on model rank 0, 0 elsewhere) with that loss's gradient for
    its logit block, and its lookup of the tokens (``labels``) with the
    gradient of <c, lookup> (owned by model rank 0) for its table
    block."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.train import cross_entropy
    mesh = make_host_mesh(model=2, device="cpu")
    vocab = mesh.axis("model")
    owner = float(mesh.coords["model"] == 0)
    rows = shd.P("data")
    logits = shd.shard_leaf(torch.from_numpy(logits_np),
                            shd.P("data", None, "model"), mesh)
    logits = logits.contiguous().requires_grad_()
    labels = shd.shard_leaf(torch.from_numpy(labels_np), rows, mesh)
    loss = cross_entropy(logits, labels, vocab)
    (g,) = torch.autograd.grad(loss * owner / 2, logits)
    table = shd.shard_leaf(torch.from_numpy(table_np), shd.P("model"), mesh)
    table = table.contiguous().requires_grad_()
    e = lm.vocab_embed(table, labels, vocab)
    c = shd.shard_leaf(torch.from_numpy(c_np), rows, mesh)
    (gt,) = torch.autograd.grad((c * e).sum() * owner, table)
    _save(out_dir, f"vocab_parallel_{rank}.pt", {
        "coords": dict(mesh.coords), "loss": float(loss),
        "dlogits": g.numpy(), "lookup": e.detach().numpy(),
        "dtable": gt.numpy()})


def moe_ep(rank, out_dir, p_np, x_np, c_np, moe_kw):
    """``apply_moe_ep`` and ``apply_moe_ep_replicated`` on a (data=2,
    model=2) mesh from the global parameters ``p_np`` and tokens ``x_np``
    (the reference test's layer): each rank takes its batch block and its
    experts, and saves its outputs, the slots of its sequence block, and
    the gradients of <c, out> (owned by model rank 0) for its tokens and
    experts."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import moe
    mesh = make_host_mesh(model=2, device="cpu")
    cfg = moe.MoEConfig(**moe_kw)
    # the reference's shard_map in_specs: experts by expert over model,
    # the router whole
    p = unflat({k: shd.shard_leaf(torch.from_numpy(v), shd.P(
        "model" if k.startswith("/experts") else None), mesh).contiguous()
        for k, v in p_np.items()})
    bspec = shd.batch_spec(mesh, x_np.shape[0], 3)
    x = shd.shard_leaf(torch.from_numpy(x_np), bspec, mesh).contiguous()
    # every model rank holds the whole output of its batch block: the
    # loss is owned by model rank 0, as the GSPMD step owns it
    c = shd.shard_leaf(torch.from_numpy(c_np), bspec, mesh) * float(
        mesh.coords["model"] == 0)
    out = {"coords": dict(mesh.coords)}
    for name, fn in (("ep", moe.apply_moe_ep),
                     ("replicated", moe.apply_moe_ep_replicated)):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in flat(p)}
        xx = x.clone().requires_grad_()
        y = fn(unflat(leaves), xx, cfg, mesh)
        grads = torch.autograd.grad((c * y).sum(), [xx, *leaves.values()])
        out[name] = {"out": y.detach().numpy(), "dx": grads[0].numpy(),
                     "dp": {k: g.numpy() for k, g in
                            zip(leaves, grads[1:])}}
    seq = x.shape[1] // 2
    block = x[:, mesh.coords["model"] * seq:(mesh.coords["model"] + 1) * seq]
    out["slots"] = moe.dispatch(p, block, cfg)[1].numpy()
    _save(out_dir, f"moe_ep_{rank}.pt", out)


def moe_forward(rank, out_dir, params_np, tokens):
    """The forward of reduced olmoe-1b-7b at capacity factor 8.0 (no
    drops) on a (model=2) mesh of this world of 2, each rank with its
    blocks of the global parameters: rank 0 saves the logits."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(
        capacity_factor=8.0)
    mesh = make_host_mesh(model=2, device="cpu")
    params = shd.shard_tree(
        unflat({k: torch.from_numpy(v) for k, v in params_np.items()}),
        shd.param_shardings(lm.model_spec(cfg), mesh), mesh)
    logits = lm.forward(params, torch.from_numpy(tokens), cfg, mesh=mesh)
    if rank == 0:
        _save(out_dir, "moe_forward.pt", logits.detach().numpy())


# ---------------------------------------------------------------------------
# the GSPMD train step and the Trainer
# ---------------------------------------------------------------------------

def optimizer(kind):
    from repro_torch import optim
    if kind == "grads":
        # b1 = 0 and no clipping: after one step the first moment is the
        # gradient, exactly
        return optim.adamw(optim.constant_schedule(1e-3), b1=0.0,
                           weight_decay=0.1)
    return optim.adamw(optim.constant_schedule(1e-3), weight_decay=0.1,
                       max_grad_norm=1.0)


def gspmd_steps(rank, out_dir, name, cases):
    """Run ``make_train_step(mesh=...)`` for each of ``cases`` (dicts:
    ``arch``, ``cfg_kw``, ``mesh_kw`` of ``make_host_mesh``, ``params``
    (flat numpy, the reference's layout), ``batches``, ``micro``,
    ``dtype``, ``opt``) from a fresh state.  Rank 0 saves each case's
    metrics, the gathered first moments and parameters."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models import for_config
    from repro_torch.optim.adamw import AdamState
    from repro_torch.train.step import TrainState, make_train_step
    results = {}
    for label, case in cases.items():
        cfg = get_config(case["arch"], reduced=True).replace(
            **case.get("cfg_kw", {}))
        if case.get("dtype"):
            cfg = cfg.replace(dtype=case["dtype"])
        mesh = make_host_mesh(device="cpu", **case["mesh_kw"])
        opt = optimizer(case.get("opt", "grads"))
        # the GSPMD step's specs, on a mesh with pipe too (its replicas)
        p_specs = shd.param_shardings(for_config(cfg).model_spec(cfg), mesh)
        specs = TrainState(p_specs, AdamState(shd.P(), p_specs, p_specs),
                           shd.P())
        global_p = params_from_jax(unflat(case["params"]), cfg)
        params = shd.shard_tree(global_p, specs.params, mesh)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32))
        step = make_train_step(cfg, opt, mesh=mesh,
                               num_microbatches=case.get("micro", 1))
        metrics = []
        for b in case["batches"]:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        g = shd.gather_tree(state, specs, mesh)
        results[label] = {
            "mesh": dict(mesh.shape), "metrics": metrics,
            "mu": {k: v.numpy() for k, v in flat(g.opt_state.mu)},
            "params": {k: v.numpy() for k, v in flat(g.params)}}
    if rank == 0:
        _save(out_dir, f"{name}.pt", results)


def _trainer(cfg, mesh_kw, ckpt_dir, **tcfg_kw):
    """A ``Trainer`` of ``cfg`` on the CPU, on a mesh of ``mesh_kw`` or
    none; returns (the trainer, its log, its global state)."""
    import contextlib
    import io

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig, Trainer
    mesh = None if mesh_kw is None else make_host_mesh(device="cpu",
                                                       **mesh_kw)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, TrainConfig(ckpt_dir=ckpt_dir, **tcfg_kw),
                          mesh=mesh, device="cpu")
        log = trainer.run()
    state = (trainer.state if mesh is None else
             shd.gather_tree(trainer.state, trainer.specs, mesh))
    return trainer, log, state


def trainer_runs(rank, out_dir, run_dir, tcfg_kw):
    """The GSPMD ``Trainer`` of reduced stablelm-3b and olmoe-1b-7b on
    (data=2, model=2) and (pod=2, data=2); then checkpoints across
    layouts: ``run_dir/meshless`` (a mesh-less run's, written before)
    restored on (data=2, model=2) by ``restore(shardings=)``, a GSPMD
    ``Trainer`` resuming it, and a GSPMD run writing ``run_dir/gspmd``.
    Rank 0 saves the losses, the gathered restore and the GSPMD run's
    final state."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import sharded_state_specs
    out = {}
    for arch in ("stablelm-3b", "olmoe-1b-7b"):
        cfg = get_config(arch, reduced=True)
        for label, mesh_kw in (("data2_model2", dict(model=2)),
                               ("pod2_data2", dict(pods=2))):
            _, log, _ = _trainer(cfg, mesh_kw, None, **tcfg_kw)
            out[(arch, label)] = [r["loss"] for r in log]
    cfg = get_config("stablelm-3b", reduced=True)
    meshless = os.path.join(run_dir, "meshless")
    mesh = make_host_mesh(model=2, device="cpu")
    specs = sharded_state_specs(cfg, mesh)
    restored, step = checkpoint.restore(
        meshless, _like(cfg), shardings=shd.named_shardings(specs, mesh))
    out["restored"] = (step, {k: v.numpy() for k, v in flat(
        shd.gather_tree(restored, specs, mesh).params)})
    steps = tcfg_kw["steps"]
    trainer, log, _ = _trainer(cfg, dict(model=2), meshless,
                               **dict(tcfg_kw, steps=steps + 1))
    out["resumed"] = (trainer.start_step, [r["step"] for r in log])
    _, _, state = _trainer(cfg, dict(model=2),
                           os.path.join(run_dir, "gspmd"), **tcfg_kw)
    out["gspmd_state"] = {k: v.numpy() for k, v in flat(state.params)}
    if rank == 0:
        _save(out_dir, "trainer_runs.pt", out)


def _like(cfg):
    """A global ``TrainState`` template of ``cfg`` under AdamW on the
    meta device (shapes and structure for ``checkpoint.restore``)."""
    from repro_torch.models import for_config
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainState
    from repro_torch.utils.tree import tree_map
    params = for_config(cfg).init_model(cfg, torch.Generator()
                                        .manual_seed(0))
    state = TrainState(params, adamw(1e-3).init(params),
                       torch.zeros((), dtype=torch.int32))
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), state)


# ---------------------------------------------------------------------------
# serving with a mesh
# ---------------------------------------------------------------------------

def drive(engine, jobs, check=lambda: None):
    """Submit two of ``jobs`` ((prompt, new tokens) pairs), step three
    times, submit the rest and drain, calling ``check`` after every step;
    the streams, by job."""
    reqs = [engine.submit(p, n) for p, n in jobs[:2]]
    for _ in range(3):
        engine.step()
        check()
    reqs += [engine.submit(p, n) for p, n in jobs[2:]]
    while engine.active or engine.scheduler.pending():
        engine.step()
        check()
    return [list(map(int, r.output)) for r in reqs]


# the counters the spill and fork runs compare
RUN_COUNTERS = ("prefix_hits", "cow_forks", "preempt_spills",
                "resume_uploads", "passes", "admissions")


def spill_run(cfg, params, check=lambda e: None, **kw):
    """A paged run of reduced zamba2-2.7b over an oversubscribed pool
    (``tests/test_torch_serve.py``'s spill test): 3 prompts of 12 tokens,
    20 new each, 6 blocks of 8 positions, 4 lanes unless ``kw`` says
    otherwise.  (streams, counters)."""
    import numpy as np

    from repro_torch.serve import ServeEngine
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 12).tolist() for _ in range(3)]
    engine = ServeEngine(cfg, params=params, **{
        **dict(max_batch=4, max_seq=48, block_size=8, kv_blocks=6,
               paged=True, share_prefix=False), **kw})
    reqs = [engine.submit(p, 20) for p in prompts]
    while engine.active or engine.scheduler.pending():
        engine.step()
        check(engine)
    return ([list(map(int, r.output)) for r in reqs],
            {k: engine.counters[k] for k in RUN_COUNTERS})


def fork_run(cfg, params, check=lambda e: None, **kw):
    """The shared-prefix trace of ``tests/test_torch_moe.py`` through a
    paged engine of reduced deepseek-v2-lite-16b: identical prompts map
    and fork MLA pages, and the pool spills.  (streams, counters)."""
    from repro_torch.serve import ServeEngine, TrafficConfig, poisson_trace
    traffic = TrafficConfig(qps=100.0, n_requests=10, n_tenants=2,
                            prompt_len=(0, 2), output_len=(4, 16),
                            vocab=cfg.vocab, seed=1, prefix_tokens=10,
                            prefix_groups=2)
    engine = ServeEngine(cfg, params=params, max_batch=4, max_seq=48,
                         block_size=4, kv_blocks=16, paged=True,
                         prefill_chunk=2, **kw)
    reqs = [engine.submit(a.prompt, a.max_new_tokens)
            for a in poisson_trace(traffic, ["t0", "t1"])]
    while engine.active or engine.scheduler.pending():
        engine.step()
        check(engine)
    return ([list(map(int, r.output)) for r in reqs],
            {k: engine.counters[k] for k in RUN_COUNTERS})


def _block_shapes(caches, specs, like, mesh):
    """The cache leaves whose shape is not this rank's block of ``like``
    (the global caches on the meta device) under ``specs``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.utils.tree import tree_leaves
    return [(tuple(c.shape), tuple(shd.shard_leaf(g, s, mesh).shape))
            for c, s, g in zip(tree_leaves(caches), tree_leaves(specs),
                               tree_leaves(like))
            if tuple(c.shape) != tuple(shd.shard_leaf(g, s, mesh).shape)]


def _engine_like(engine):
    """The global caches of ``engine`` on the meta device."""
    from repro_torch.serve.decode import init_caches, init_paged_caches
    if engine.paged:
        return init_paged_caches(engine.cfg, engine.pool.num_blocks,
                                 engine.pool.block_size, engine.max_batch,
                                 "meta")
    return init_caches(engine.cfg, engine.max_batch + 1, engine.max_seq,
                       "meta")


def serve_runs(rank, out_dir, spec, params_np):
    """Serving with a mesh for each mesh and arch of ``spec`` (as
    ``gspmd_reference.run_serve_reference`` takes it) from the global
    parameters ``params_np`` ({arch: flat numpy}): ``generate(mesh=)``'s
    tokens, the logits of ``decode_step(mesh=)`` (gathered over the
    batch), the slot and paged engines' streams, and a zamba2 spill run
    and a deepseek fork run with their counters, the logits of
    ``spec["init_draw"]``'s arch from its parameters
    (``params_np["init_draw"]``), and on
    ``spec["rows_on_data"]["mesh"]`` the streams of its cases' engines,
    whose slot rows divide over ``data``; after every pass and
    every engine step, the cache leaves whose shape left this rank's
    block (``bad``).  Every rank saves its results."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import for_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import ServeEngine, decode_step, generate
    from repro_torch.serve.decode import init_caches
    out = {"bad": []}
    for mname, mkw in spec["meshes"].items():
        mesh = make_host_mesh(device="cpu", **mkw)
        out[mname] = {"coords": dict(mesh.coords)}

        def logits_run(cfg, params, arch, where):
            """The logits of ``decode_step(mesh=)`` over the arch's
            passes, gathered over the batch."""
            steps = torch.tensor(spec["logits"]["tokens"][arch])
            B = steps.shape[1]
            like = init_caches(cfg, B, spec["generate"]["max_seq"], "meta")
            specs = shd.decode_cache_shardings(cfg, like, mesh)
            caches = shd.shard_zeros(like, specs, mesh, "cpu")
            local = shd.shard_tree(params, shd.param_shardings(
                for_config(cfg).model_spec(cfg), mesh), mesh)
            bspec = shd.batch_spec(mesh, B)
            got = []
            for i, tok in enumerate(steps):
                logits, caches = decode_step(
                    local, caches, shd.shard_leaf(tok, bspec, mesh), i, cfg,
                    mesh=mesh, specs=specs)
                got.append(shd.gather_leaf(
                    logits, shd.P(bspec[0], None), mesh).numpy())
                out["bad"] += [(where + (i,), b) for b in
                               _block_shapes(caches, specs, like, mesh)]
            return got

        def check(engine, where):
            out["bad"] += [(where, b) for b in _block_shapes(
                engine.caches, engine._specs, _engine_like(engine), mesh)]

        for arch in spec["archs"]:
            cfg = get_config(arch, reduced=True)
            params = params_from_jax(unflat(params_np[arch]), cfg)
            g = spec["generate"]
            res = out[mname][arch] = {}
            res["tokens"] = generate(
                params, cfg, torch.tensor(g["prompts"][arch]), g["new"],
                max_seq=g["max_seq"], mesh=mesh).numpy()
            res["logits"] = logits_run(cfg, params, arch, (mname, arch))
            if cfg.family == "encdec":
                continue
            for mode in ("slot", "paged"):
                engine = ServeEngine(cfg, params=params, mesh=mesh,
                                     paged=mode == "paged", **spec["engine"])
                res[mode] = drive(engine, spec["jobs"][arch], lambda: check(
                    engine, (mname, arch, mode)))
                res[mode + "_pool_bytes"] = engine.kv_bytes_allocated()
        init = spec["init_draw"]
        cfg = get_config(init["arch"], reduced=True)
        out[mname]["init_draw"] = logits_run(
            cfg, params_from_jax(unflat(params_np["init_draw"]), cfg),
            init["arch"], (mname, "init_draw"))
        rows = spec["rows_on_data"]
        for arch, mode in (rows["cases"] if mname == rows["mesh"] else ()):
            cfg = get_config(arch, reduced=True)
            engine = ServeEngine(cfg, mesh=mesh, paged=mode == "paged",
                                 params=params_from_jax(
                                     unflat(params_np[arch]), cfg),
                                 **rows["engine"])
            out[mname][arch][mode + "/rows_on_data"] = drive(
                engine, spec["jobs"][arch], lambda: check(
                    engine, (mname, arch, mode, "rows_on_data")))
        for arch, run in (("zamba2-2.7b", spill_run),
                          ("deepseek-v2-lite-16b", fork_run)):
            cfg = get_config(arch, reduced=True)
            params = params_from_jax(unflat(params_np[arch]), cfg)
            out[mname][run.__name__] = run(
                cfg, params, lambda e: check(e, (mname, run.__name__)),
                mesh=mesh)
            if run is spill_run and mname == rows["mesh"]:
                out[mname]["spill_run/rows_on_data"] = spill_run(
                    cfg, params, lambda e: check(e, (mname, "rows")),
                    mesh=mesh, max_batch=rows["engine"]["max_batch"])
    _save(out_dir, f"serve_{rank}.pt", out)


def staged_sums(rank, out_dir):
    """On (data=2, model=2), rank (d, m) with index 2d + m: ``psum`` over
    both axes of a small and of a large input, by the CPU transport and
    with the mesh marked host-staged; and ``shift_down`` of its input over
    (data, model)."""
    from repro_torch.dist import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2, device="cpu")
    index = 2 * mesh.coords["data"] + mesh.coords["model"]
    axes = [mesh.axis("data"), mesh.axis("model")]
    out = {"index": index, "sums": {}}
    for name, shape in (("small", (8, 1, 64)),
                        ("large", (col.GATHER_SUM_BYTES // 4 + 1,))):
        x = torch.from_numpy(rank_inputs(index, shape)[0])
        mesh.staged = False
        plain = col.psum(x, axes).numpy()
        mesh.staged = True
        out["sums"][name] = (plain, col.psum(x, axes).numpy())
    mesh.staged = False
    out["shifted"] = col.shift_down(
        torch.from_numpy(rank_inputs(index, (3, 4))[0]), axes).numpy()
    _save(out_dir, f"staged_sums_{rank}.pt", out)
