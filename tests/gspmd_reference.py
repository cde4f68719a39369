"""The reference's GSPMD train step for the port's GSPMD tests
(``tests/test_torch_gspmd*.py``), and the bounds they hold the port to.

``run_reference`` runs the JAX package's ``make_train_step(cfg, opt,
mesh=mesh)`` under ``jax.jit`` in a subprocess with 4 host devices, on a
mesh built with ``AxisType.Auto`` axes and entered with ``jax.set_mesh``
(the axes of ``repro.launch.mesh.make_host_mesh`` are ``Explicit`` in
jax 0.9.0, which its ``with_sharding_constraint`` rejects; ROADMAP
A14b).  Each case starts from the reference's parameters (PRNGKey 0) or
from parameters the caller passes."""

import json

import numpy as np

_SCRIPT = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import optim
from repro.configs import get_config
from repro.data.pipeline import make_data
from repro.launch.mesh import host_mesh_shape
from repro.models import encdec, lm
from repro.train.step import TrainState, make_train_step

def flat(t, pre=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from flat(t[k], pre + "/" + k)
    else:
        yield pre, np.asarray(t)

def unflat(pairs):
    out = {}
    for path, leaf in pairs.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(leaf)
    return out

cases = json.loads(open("CASES_PATH").read())
for c in cases:
    cfg = get_config(c["arch"], reduced=True).replace(**c["cfg_kw"])
    model = encdec if cfg.family == "encdec" else lm
    if c.get("params"):
        params = unflat(dict(np.load(c["params"])))
    else:
        params = model.init_model(cfg, jax.random.PRNGKey(0))
    res = {"p0" + k: v for k, v in flat(params)}
    if c["opt"] == "grads":
        opt = optim.adamw(optim.constant_schedule(1e-3), b1=0.0,
                          weight_decay=0.1)
    else:
        opt = optim.adamw(optim.linear_warmup_cosine(*c["opt"]),
                          weight_decay=0.1, max_grad_norm=1.0)
    data = make_data(cfg, c["seq"], c["batch"], c.get("seed", 0))
    shape, names = host_mesh_shape(4, **c["mesh"])
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
    with jax.set_mesh(mesh):
        step = jax.jit(make_train_step(cfg, opt, mesh=mesh,
                                       num_microbatches=c["micro"]))
        state = TrainState(params, opt.init(params),
                           jnp.zeros((), jnp.int32))
        for i in range(c["steps"]):
            state, m = step(state, data.batch_at(c.get("first", 0) + i))
            res[f"loss{i}"] = float(m["loss"])
            res[f"gnorm{i}"] = float(m["grad_norm"])
    res.update({"mu" + k: v for k, v in flat(state.opt_state.mu)})
    res.update({"p1" + k: v for k, v in flat(state.params)})
    res["mesh"] = json.dumps(dict(mesh.shape))
    np.savez(c["out"], **res)
    print(c["name"], dict(mesh.shape), res["loss0"])
"""


def run_reference(subproc, tmp_dir, cases):
    """Run each of ``cases`` (``name``, ``arch``, ``cfg_kw``, ``mesh``:
    keywords of ``host_mesh_shape``, ``micro``, ``seq``, ``batch``,
    ``steps``, ``opt``: ``"grads"`` or the Trainer's (lr, warmup, steps),
    optional ``params``: an ``.npz`` of flat parameters, ``seed`` and
    ``first`` of the data: the steps take batches ``first``, ``first +
    1``, ...) in one subprocess; returns {name: its arrays}."""
    for c in cases:
        c["out"] = str(tmp_dir / f"ref_{c['name']}.npz")
        c.setdefault("cfg_kw", {})
        c.setdefault("micro", 1)
        c.setdefault("seq", 16)
        c.setdefault("batch", 8)
        c.setdefault("steps", 1)
        c.setdefault("opt", "grads")
    (tmp_dir / "cases.json").write_text(json.dumps(cases))
    subproc(_SCRIPT.replace("CASES_PATH", str(tmp_dir / "cases.json")),
            n_devices=4)
    return {c["name"]: dict(np.load(c["out"])) for c in cases}


def params_of(ref, key="p0"):
    """The flat parameters ``key`` (``p0`` before the step, ``p1``
    after) of a reference case."""
    n = len(key)
    return {k[n:]: v for k, v in ref.items() if k.startswith(key + "/")}


def close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


def hold_step(port, ref, exact, factor, lr=1e-3):
    """Hold one step of the port (``port``: a ``gspmd_steps`` result)
    against the reference's (``ref``), ``exact`` being the f64 gradients
    ({path: array}) of the same function: the loss within 1e-5 relative;
    the reference's own error against ``exact`` within 1e-2 (of each
    leaf's largest entry, or 1e-5 for a leaf whose exact gradient
    vanishes; of the grad-norm, relative); each gradient
    (AdamW's first moment at b1 = 0) within atol 1e-5 plus ``factor``
    times that error, and the grad-norm within 3e-4 relative plus
    ``factor`` times its error; the parameters after the step within
    ``lr`` times the update's change that those gradient differences
    allow (an entry moves by lr * g / (|g| + 1e-8) + lr * wd * p)."""
    m = port["metrics"][0]
    assert close(m["loss"], ref["loss0"], 1e-5), (m["loss"], ref["loss0"])
    exact_norm = float(np.sqrt(sum(float(np.sum(np.square(e)))
                                   for e in exact.values())))
    norm_err = abs(ref["gnorm0"] - exact_norm) / exact_norm
    assert norm_err <= 1e-2, norm_err
    assert close(m["grad_norm"], ref["gnorm0"], 3e-4 + factor * norm_err), \
        (m["grad_norm"], ref["gnorm0"])
    assert sorted(port["mu"]) == sorted(exact)
    top = max(float(np.abs(e).max()) for e in exact.values())
    for path, got in port["mu"].items():
        want, e = ref["mu" + path], exact[path]
        jax_err = float(np.abs(want - e).max())
        scale = float(np.abs(e).max())
        if scale <= 1e-12 * top:
            # no gradient in exact arithmetic (whisper's cross-attention
            # key bias: the softmax cancels it), so no scale for the
            # relative check: the atol holds it
            assert jax_err <= 1e-5, (path, jax_err)
        else:
            assert jax_err <= 1e-2 * scale, (path, jax_err)
        bound = 1e-5 + factor * jax_err
        np.testing.assert_allclose(got, want, atol=bound, rtol=0,
                                   err_msg=path)
        # u = g / (|g| + 1e-8) moves by at most 2 |dg| / (|g| + 1e-8)
        # where the gradients differ by dg (and by 2 at most, a sign)
        du = np.minimum(2 * bound / (np.abs(want) + 1e-8), 2.0)
        np.testing.assert_array_less(
            np.abs(port["params"][path] - ref["p1" + path]),
            lr * du + 2e-6, err_msg=path)


def trainer_params(arch):
    """The parameters a ``Trainer`` of reduced ``arch`` draws on the CPU
    from seed 0, flat."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import for_config
    cfg = get_config(arch, reduced=True)
    params = for_config(cfg).init_model(cfg, torch.Generator("cpu")
                                        .manual_seed(0))
    return {k: v.numpy() for k, v in _flat(params)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def trainer_reference(subproc, tmp_dir, tcfg_kw, archs, meshes):
    """The reference's sharded step over a port ``Trainer``'s steps (its
    AdamW, warmup-cosine schedule and data, ``TrainConfig(**tcfg_kw)``)
    on each of ``meshes`` ({label: keywords of ``host_mesh_shape``}) from
    the port ``Trainer``'s initial parameters; {f"{arch}_{label}": its
    arrays}."""
    from repro_torch.train import TrainConfig
    tc = TrainConfig(**tcfg_kw)
    cases = []
    for arch in archs:
        init = tmp_dir / f"init_{arch}.npz"
        np.savez(init, **trainer_params(arch))
        for label, mesh in meshes.items():
            cases.append(dict(name=f"{arch}_{label}", arch=arch, mesh=mesh,
                              seq=tc.seq_len, batch=tc.global_batch,
                              steps=tc.steps, params=str(init),
                              seed=tc.seed,
                              opt=[tc.lr, tc.warmup, tc.steps]))
    return run_reference(subproc, tmp_dir, cases)



_SERVE_SCRIPT = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.dist import sharding as shd
from repro.launch.mesh import host_mesh_shape
from repro.models import encdec, lm
from repro.serve import engine as jengine
from repro.serve.decode import decode_step, init_caches

def unflat(pairs):
    out = {}
    for path, leaf in pairs.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(leaf)
    return out

def drive(cfg, params, mode, kw, jobs):
    eng = jengine.ServeEngine(cfg, params=params, mesh=mesh,
                              paged=mode == "paged", **kw)
    reqs = [eng.submit(p, n) for p, n in jobs[:2]]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p, n) for p, n in jobs[2:]]
    eng.run()
    return [list(map(int, r.output)) for r in reqs]

def logits_run(cfg, params, arch):
    model = encdec if cfg.family == "encdec" else lm
    steps = np.asarray(spec["logits"]["tokens"][arch], np.int32)
    caches = init_caches(cfg, steps.shape[1], spec["generate"]["max_seq"])
    caches = jax.device_put(
        caches, shd.decode_cache_shardings(cfg, caches, mesh))
    placed = jax.device_put(
        params, shd.param_shardings(model.model_spec(cfg), mesh))
    step = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg,
                                                    mesh=mesh))
    out = []
    for i, tok in enumerate(steps):
        logits, caches = step(placed, caches, jnp.asarray(tok), jnp.int32(i))
        out.append(np.asarray(logits))
    return out

spec = json.loads(open("SPEC_PATH").read())
mname = "MESH_LABEL"
arrays, streams = {}, {}
shape, names = host_mesh_shape(4, **spec["meshes"][mname])
mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
with jax.set_mesh(mesh):
    for arch in spec["archs"]:
        cfg = get_config(arch, reduced=True)
        params = unflat(dict(np.load(spec["params"][arch])))
        g = spec["generate"]
        prompt = jnp.asarray(np.asarray(g["prompts"][arch]), jnp.int32)
        toks = jengine.generate(params, cfg, prompt, g["new"],
                                max_seq=g["max_seq"], mesh=mesh)
        arrays[f"{mname}/{arch}/tokens"] = np.asarray(toks)
        for i, lg in enumerate(logits_run(cfg, params, arch)):
            arrays[f"{mname}/{arch}/logits{i}"] = lg
        if cfg.family == "encdec":
            continue
        for mode in ("slot", "paged"):
            streams[f"{mname}/{arch}/{mode}"] = drive(
                cfg, params, mode, spec["engine"], spec["jobs"][arch])
    init = spec["init_draw"]
    params = unflat(dict(np.load(init["params"])))
    cfg = get_config(init["arch"], reduced=True)
    for i, lg in enumerate(logits_run(cfg, params, init["arch"])):
        arrays[f"{mname}/init_draw/logits{i}"] = lg
    rows = spec["rows_on_data"]
    for arch, mode in (rows["cases"] if mname == rows["mesh"] else ()):
        cfg = get_config(arch, reduced=True)
        params = unflat(dict(np.load(spec["params"][arch])))
        streams[f"{mname}/{arch}/{mode}/rows_on_data"] = drive(
            cfg, params, mode, rows["engine"], spec["jobs"][arch])
np.savez("OUT_NPZ", **arrays)
open("OUT_JSON", "w").write(json.dumps(streams))
"""


def start_serve_reference(tmp_dir, spec):
    """Start the reference's serving, one subprocess with 4 host devices
    a mesh of ``spec["meshes"]`` ({label: keywords of
    ``host_mesh_shape``}; ``AxisType.Auto`` axes under ``jax.set_mesh``),
    for each of ``spec["archs"]`` from its parameters (``spec["params"]``:
    {arch: an ``.npz`` of flat parameters}): ``generate(mesh=)`` of
    ``spec["generate"]`` (``prompts`` by arch, ``new``, ``max_seq``), the
    logits of ``decode_step(mesh=)`` over ``spec["logits"]["tokens"]
    [arch]`` ((passes, B, 1), pass ``i`` at position ``i``, caches of
    ``max_seq``; and the same for ``spec["init_draw"]["arch"]`` from the
    parameters ``spec["init_draw"]["params"]``), and for the decoder-only
    families the streams of a slot
    and a paged ``ServeEngine(mesh=)`` (keywords ``spec["engine"]``) over
    ``spec["jobs"][arch]`` ((prompt, new tokens) pairs: two submitted,
    three steps, the rest submitted, drained), and on
    ``spec["rows_on_data"]["mesh"]`` the same for each (arch, mode) of its
    ``cases`` by an engine of its ``engine`` keywords.  Returns a function
    that waits for them and returns ({"mesh/arch/tokens" |
    "mesh/arch/logits{i}" | "mesh/init_draw/logits{i}": array},
    {"mesh/arch/slot" | "mesh/arch/paged" | "mesh/arch/mode/rows_on_data":
    streams})."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    (tmp_dir / "serve_spec.json").write_text(json.dumps(spec))
    procs = {}
    for label in spec["meshes"]:
        code = (_SERVE_SCRIPT
                .replace("SPEC_PATH", str(tmp_dir / "serve_spec.json"))
                .replace("MESH_LABEL", label)
                .replace("OUT_NPZ", str(tmp_dir / f"serve_{label}.npz"))
                .replace("OUT_JSON", str(tmp_dir / f"serve_{label}.json")))
        procs[label] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def wait(timeout=600):
        arrays, streams = {}, {}
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode:
                raise AssertionError(f"reference serving on {label} failed "
                                     f"(rc={proc.returncode})\n{err[-4000:]}")
            arrays.update(np.load(tmp_dir / f"serve_{label}.npz"))
            streams.update(json.loads(
                (tmp_dir / f"serve_{label}.json").read_text()))
        return arrays, streams
    return wait
