"""The port's AOT dry run (``repro_torch.launch.{specs,jcost,roofline,
dryrun}``) on the CPU, with no card.

Twins of ``tests/test_dryrun_smoke.py``'s jax-free cases (model flops,
the production mesh shapes, the collective counter, flops linear in
depth), ``Mesh.axis_ranks`` under ``FakeTensorMode``, parity of the
port's counted matrix-product flops with the reference's mesh-less
``cost_of`` (its ``dot_general`` flops), and the reference's two
dry-run cells run on the port.  Whatever needs a process group (a fake
one) runs in a subprocess, so that no group leaks into the worker's
other files.
"""

import functools
import json

import pytest

from repro_torch.configs import ARCHS

# the parity cases' shapes: two chunks of the SSD's 64 (one chunk's
# backward skips the products that only the next chunk reads)
BATCH, SEQ = 2, 128


# ---------------------------------------------------------------------------
# twins of the reference's jax-free cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    from repro.configs import get_config as jax_config
    from repro.launch.dryrun import model_flops as jax_model_flops

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import model_flops
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in SHAPES:
        assert model_flops(cfg, shape) == jax_model_flops(jcfg, shape), shape
    if arch == "stablelm-3b":
        assert model_flops(cfg, "train_4k") == \
            6.0 * cfg.n_active_params() * 4096 * 256


_MESH_CODE = """
import torch.distributed as dist
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_production_mesh
fake_process_group(256)
m1 = make_production_mesh(device="cpu")
assert m1.shape == {"data": 16, "model": 16} and dist.get_world_size() == 256
m3 = make_production_mesh(pipe=2, device="cpu")
assert m3.shape == {"pipe": 2, "data": 8, "model": 16}
fake_process_group(512)
m2 = make_production_mesh(multi_pod=True, device="cpu")
assert m2.shape == {"pod": 2, "data": 16, "model": 16}
assert dist.get_world_size() == 512 and m2.grid.shape == (2, 16, 16)
print("MESH-OK")
"""


def test_production_mesh_shapes(subproc):
    assert "MESH-OK" in subproc(_MESH_CODE, timeout=300)


_COLLECTIVES_CODE = """
import math
import torch
from repro_torch.dist import collectives as col
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_host_mesh
fake_process_group(4)
mesh = make_host_mesh(model=2, device="cpu")          # (data 2, model 2)
d, m = mesh.axis("data"), mesh.axis("model")
with rl.count_collectives() as c:
    x = torch.zeros(128, 256, requires_grad=True)
    y = col.psum(x, m)                                  # f32 (128, 256)
    col.all_gather(torch.zeros(16, 4096, dtype=torch.bfloat16), d, 0,
                   tiled=True)                          # -> (32, 4096)
    col.psum_scatter(torch.zeros(64, 32), m, 0)         # -> (32, 32)
    col.ppermute(torch.zeros(64), d, [(0, 1), (1, 0)])
    col.all_to_all(torch.zeros(2, 8), m, 0, 0)
    col.shift_down(torch.zeros(4, 4), [d, m])
    col.psum(torch.zeros(8), [d, m])                    # one an axis
    y.sum().backward()                                  # psum's backward
got = c.as_dict()
want = {"all-reduce": 2 * 128 * 256 * 4 + 2 * 8 * 4,
        "all-gather": 32 * 4096 * 2, "reduce-scatter": 32 * 32 * 4,
        "all-to-all": 2 * 8 * 4, "collective-permute": 64 * 4 + 4 * 4 * 4}
for kind, n in want.items():
    assert got[kind] == n, (kind, got[kind], n)
assert got["total"] == sum(want.values())
assert got["counts"] == {"all-reduce": 4, "all-gather": 1,
                         "reduce-scatter": 1, "all-to-all": 1,
                         "collective-permute": 2}, got["counts"]
assert c.ops[0] == ("all-reduce", 131072.0, (0, 1))
assert c.ops[-1] == ("all-reduce", 131072.0, (0, 1))   # the backward's
assert list(got)[-2:] == ["total", "counts"]
# one node holds all four ranks: every collective at NVLink's rate
assert math.isclose(c.seconds(), got["total"] / rl.NVLINK_BW, rel_tol=1e-12)
assert rl.link_bw(range(8)) == rl.NVLINK_BW
assert rl.link_bw((0, 8)) == rl.NET_BW
print("COLL-OK")
"""


def test_collective_counter_by_kind(subproc):
    assert "COLL-OK" in subproc(_COLLECTIVES_CODE, timeout=300)


def test_flops_linear_in_a_python_loop():
    """The reference's trip-count case, as the port runs it: a Python
    loop over 2 and 4 (64 x 64) matmuls."""
    import torch

    from repro_torch.launch.jcost import cost_of

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    x = torch.zeros(64, 64)
    c2 = cost_of(f, x, [torch.zeros(64, 64)] * 2)
    c4 = cost_of(f, x, [torch.zeros(64, 64)] * 4)
    assert c2["flops"] == 2 * 2 * 64 ** 3
    assert c4["flops"] == 2 * c2["flops"]


def test_fused_attention_counts_the_kernels_traffic():
    """``fused_attn=True``: one ``ops.flash_attention`` call is one op,
    its plain version's flops, and q, k, v and the output once for
    ``bytes_fused`` (beside the arguments, read once)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.jcost import cost_of

    def f(q, k, v):
        return ops.flash_attention(q, k, v)

    q, k, v = (torch.zeros(2, 4, 64, 16) for _ in range(3))
    plain = cost_of(f, q, k, v)
    fused = cost_of(f, q, k, v, fused_attn=True)
    one = q.numel() * q.element_size()
    assert fused["flops"] == plain["flops"] > 0
    assert fused["bytes_naive"] == plain["bytes_naive"]
    assert fused["bytes_fused"] == 4 * one + 3 * one
    assert plain["bytes_fused"] > fused["bytes_fused"]
    assert not ops.ATTENTION_OBSERVERS


def test_train_step_flops_linear_in_depth():
    """The reduced stablelm-3b train step, remat on, at 1, 2 and 4
    layers: its flops lie on one line (every layer and its recompute
    counted once)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.jcost import cost_of
    from repro_torch.launch.specs import cell
    flops = {}
    for n in (1, 2, 4):
        cfg = get_config("stablelm-3b", reduced=True).replace(n_layers=n,
                                                             remat=True)
        with FakeTensorMode():
            flops[n] = cost_of(*_flat(cell(cfg, "train", SEQ, BATCH)))["flops"]
    assert flops[2] > flops[1] > 0
    assert flops[4] - flops[2] == 2 * (flops[2] - flops[1]), flops


def _flat(fn_args):
    fn, args = fn_args
    return (fn,) + tuple(args)


_AXIS_RANKS_CODE = """
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.dist import collectives as col
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_production_mesh
fake_process_group(512)
mesh = make_production_mesh(multi_pod=True, device="cpu")
outside = mesh.axis_ranks(("pod", "model"))
assert outside == tuple(r for p in (0, 256) for r in range(p, p + 16))
with FakeTensorMode():
    assert mesh.axis_ranks(("pod", "model")) == outside
    assert mesh.axis_ranks("data") == tuple(range(0, 256, 16))
    y = col.shift_down(torch.zeros(3, 5), [mesh.axis("pod"),
                                           mesh.axis("model")])
    assert tuple(y.shape) == (3, 5)
print("RANKS-OK")
"""


def test_axis_ranks_of_combined_axes_under_fake_tensors(subproc):
    """Fault C5: ``Mesh.axis_ranks`` read the device mesh's rank tensor
    (``.tolist()``), which raises under ``FakeTensorMode``; it reads a
    host copy taken when the mesh is built."""
    assert "RANKS-OK" in subproc(_AXIS_RANKS_CODE, timeout=300)


_PIPE_CODE = """
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.jcost import cost_of
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import cell
fake_process_group(4)
mesh = make_host_mesh(pipe=2, device="cpu")           # (pipe 2, data 2)
seen = {}
for arch in ("stablelm-3b", "whisper-large-v3"):
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = cell(get_config(arch, reduced=True), "train", 32, 8, mesh)
        with rl.count_collectives() as c:
            cost = cost_of(fn, *args)
    seen[arch] = (cost["flops"], c.as_dict()["counts"])
# the pipeline step: the ring's permutes
assert seen["stablelm-3b"][0] > 0, seen
assert seen["stablelm-3b"][1]["collective-permute"] > 0, seen
# encdec does not stage: the GSPMD step, replicated over pipe
assert seen["whisper-large-v3"][0] > 0, seen
assert seen["whisper-large-v3"][1]["collective-permute"] == 0, seen
assert seen["whisper-large-v3"][1]["all-gather"] > 0, seen
print("PIPE-OK", seen)
"""


def test_pipe_mesh_train_cell_pipeline_or_gspmd_fallback(subproc):
    """On a mesh with ``pipe``, a train cell is the pipeline step where
    it stages the config, else (``PipelineStepError``: encdec) the GSPMD
    step, which ignores ``pipe``, as the reference's ``lowerable``."""
    assert "PIPE-OK" in subproc(_PIPE_CODE, timeout=300)


_VOCAB_CODE = """
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.launch import jcost
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import cell
fake_process_group(8)
mesh = make_host_mesh(model=4, device="cpu")
assert mesh.shape == {"data": 2, "model": 4}, mesh.shape
base = get_config("stablelm-3b", reduced=True)

def products(n, mesh, batch):
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = cell(base.replace(n_layers=n), "train", 32, batch, mesh)
        with rl.count_collectives() as c, jcost.counting() as mode:
            fn(*args)
    return mode.cost.matmul_flops, c

# the products outside the layers: the count at 1 layer less the slope;
# the rank's batch block (8 over data 2) against a mesh-less batch of 4
(m1, coll), (m2, _) = products(1, mesh, 8), products(2, mesh, 8)
(l1, _), (l2, _) = products(1, None, 4), products(2, None, 4)
head, meshless_head = m1 - (m2 - m1), l1 - (l2 - l1)
assert head > 0 and head * 4 == meshless_head, (head, meshless_head)
model = mesh.axis_ranks("model")
table = base.vocab * base.d_model * 4
over_model = [b for kind, b, r in coll.ops
              if kind == "all-gather" and r == model]
assert sum(over_model) < table, (over_model, table)
print("VOCAB-OK", head, meshless_head, over_model)
"""


def test_train_step_head_is_vocabulary_parallel(subproc):
    """Reduced stablelm-3b's GSPMD train step on (data 2, model 4) over
    a fake process group: the matrix products outside the layers (the
    head's forward and backward), counted by ``launch.jcost`` as the
    count at 1 layer less the slope from 1 to 2, are a quarter of the
    mesh-less step's at the rank's batch block; and
    ``count_collectives`` sees no all-gather of the table over
    ``model`` (the all-gathers over ``model`` together move less than
    the table's bytes)."""
    assert "VOCAB-OK" in subproc(_VOCAB_CODE, timeout=300)


# ---------------------------------------------------------------------------
# parity with the reference's mesh-less cost_of
# ---------------------------------------------------------------------------

PARITY_ARCHS = ("stablelm-3b", "olmoe-1b-7b", "mamba2-1.3b",
                "whisper-large-v3")
KINDS = ("train", "prefill", "decode")


def _jax_cell(arch, kind):
    """The reference's mesh-less (fn, args) of ``kind`` at BATCH x SEQ:
    ``make_train_step``, the forward, ``decode_step`` over
    ``init_caches`` (ShapeDtypeStructs)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import encdec, lm
    from repro.optim import adamw, constant_schedule
    from repro.serve import decode as serve_decode
    from repro.train.step import TrainState, make_train_step

    cfg = get_config(arch, reduced=True)
    model = encdec if cfg.family == "encdec" else lm
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(functools.partial(model.init_model, cfg),
                            jax.random.PRNGKey(0))
    tokens = sds((BATCH, SEQ), jnp.int32)
    frames = sds((BATCH, SEQ, cfg.d_model), jnp.bfloat16)
    if kind == "train":
        opt = adamw(constant_schedule(3e-4), weight_decay=0.1,
                    max_grad_norm=1.0)
        state = TrainState(params=params,
                           opt_state=jax.eval_shape(opt.init, params),
                           step=sds((), jnp.int32))
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.frontend == "audio_frames":
            batch["frames"] = frames
        return make_train_step(cfg, opt), (state, batch)
    if kind == "prefill":
        if cfg.family == "encdec":
            return (lambda p, f, t: encdec.forward(p, f, t, cfg),
                    (params, frames, tokens))
        return lambda p, t: lm.forward(p, t, cfg), (params, tokens)
    caches = jax.eval_shape(functools.partial(serve_decode.init_caches, cfg,
                                              BATCH, SEQ))
    return (lambda p, c, t, pos: serve_decode.decode_step(p, c, t, pos, cfg),
            (params, caches, sds((BATCH, 1), jnp.int32),
             sds((), jnp.int32)))


def _jax_dot_flops(fn, args):
    """The reference's ``dot_general`` flops of ``fn(*args)``: its
    ``jcost`` walk (scan bodies times their trip counts, calls entered)
    summing ``_dot_flops`` alone."""
    import jax
    from repro.launch import jcost

    def walk(jaxpr):
        total = 0.0
        for eqn in jaxpr.eqns:
            prim = eqn.primitive.name
            if prim == "scan":
                total += walk(eqn.params["jaxpr"].jaxpr) * float(
                    eqn.params["length"])
            elif prim == "while":
                total += walk(eqn.params["body_jaxpr"].jaxpr)
            elif prim == "cond":
                total += max(walk(b.jaxpr) for b in eqn.params["branches"])
            elif prim in jcost._CALL:
                inner = eqn.params.get("jaxpr") or eqn.params.get(
                    "call_jaxpr")
                if inner is not None:
                    total += walk(getattr(inner, "jaxpr", inner))
            elif prim == "dot_general":
                total += jcost._dot_flops(eqn)
        return total

    return walk(jax.make_jaxpr(fn)(*args).jaxpr)


def _form_difference(arch, kind):
    """Port minus reference matrix-product flops that the two forms of
    the same function differ by, as a formula of the shapes (0 where
    they do the same products):

    * moe: the reference combines the experts' outputs by two one-hot
      products, ``einsum("tk,tke->te")`` (2·T·k·E) and
      ``einsum("te,etd->td")`` (2·T·E·D) a layer; the port gathers each
      token's k outputs and sums them (no product).  Training adds their
      backward: the gate's cotangent (2·T·k·E) and both of the second
      product's (2 x 2·T·E·D); the one-hot takes none.
    * ssm: the reference scans the SSD a position at a time (one
      ``bhpn,bhn->bhp`` product, 2·B·S·H·P·N a layer); the port's chunked
      dual form (``kernels/ref.py::ssd_chunk``, ROADMAP §C) takes four
      products over nc chunks of L: C·Bᵀ (2·B·G·nc·L²·N), its masked
      scores times X (2·B·H·nc·L²·P), the chunks' states (2·B·H·nc·P·L·N)
      and their outputs (2·B·H·nc·L·N·P).  Training runs each product's
      two cotangents, three times the forward's products in both.
      Decoding steps the same recurrence in both.
    * encdec decode: the reference projects the new token's cross keys
      and values (``qkv_project(...)[0]`` keeps q) and drops them, 2 x
      2·B·d·(KH·D) a decoder layer; the port projects q alone.
    """
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    if cfg.family == "moe":
        T = BATCH * (1 if kind == "decode" else SEQ)
        L, E, k, D = (cfg.n_layers - cfg.first_dense_layers, cfg.n_experts,
                      cfg.top_k, cfg.d_model)
        per = 2 * T * E * ((2 * k + 3 * D) if kind == "train" else (k + D))
        return -L * per
    if cfg.family == "ssm" and kind != "decode":
        B, S = BATCH, SEQ
        H, P, N, G = cfg.ssm_heads, cfg.ssm_head_p, cfg.ssm_state, \
            cfg.ssm_groups
        C = 64                                  # ops.ssd_chunk's chunk
        nc = -(-S // C)
        port = 2 * B * (G * nc * C * C * N + H * nc * C * C * P
                        + 2 * H * nc * C * P * N)
        ref = 2 * B * S * H * P * N
        return cfg.n_layers * (port - ref) * (3 if kind == "train" else 1)
    if cfg.family == "encdec" and kind == "decode":
        return -cfg.dec_layers * 2 * (2 * BATCH * cfg.d_model
                                      * cfg.n_kv_heads * cfg.head_dim)
    return 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_matmul_flops_match_reference_cost_of(arch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.launch.jcost import cost_of as jax_cost_of
    from repro_torch.configs import get_config
    from repro_torch.launch import jcost
    from repro_torch.launch.specs import cell

    jfn, jargs = _jax_cell(arch, kind)
    want = _jax_dot_flops(jfn, jargs)
    with FakeTensorMode():
        fn, args = cell(get_config(arch, reduced=True), kind, SEQ, BATCH)
        with jcost.counting() as mode:
            fn(*args)
        mode.cost.bytes_fused += sum(
            t.numel() * t.element_size() for t in jcost.tensors(args))
    got = mode.cost.matmul_flops
    ref_all = jax_cost_of(jfn, *jargs)
    print(f"{arch} {kind}: matmul flops port {got:.0f} reference {want:.0f}"
          f" (form difference {_form_difference(arch, kind)}); flops port "
          f"{mode.cost.flops:.0f} reference {ref_all['flops']:.0f}; "
          f"bytes_fused port {mode.cost.bytes_fused:.0f} reference "
          f"{ref_all['bytes_fused']:.0f}")
    assert want > 0
    assert got == pytest.approx(want + _form_difference(arch, kind),
                                rel=1e-9, abs=0)


# ---------------------------------------------------------------------------
# the reference's two cells, on the port
# ---------------------------------------------------------------------------

_CELL_CODE = """
import json, sys
from repro_torch.launch.dryrun import run_cell
r = run_cell("{arch}", "{shape}", multi_pod={multi})
assert r["status"] == "ok", r.get("trace", r)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print("RECORD " + json.dumps(r))
"""

# the reference's record keys (``repro/launch/dryrun.py::run_cell``), with
# ``trace_s`` in place of ``lower_s``/``compile_s``
_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "trace_s",
                "memory", "roofline"}
_ROOFLINE_KEYS = {"chips", "flops_global", "bytes_global",
                  "coll_bytes_global", "compute_s", "memory_s",
                  "collective_s", "dominant", "model_flops", "useful_ratio",
                  "coll_breakdown"}


@pytest.mark.parametrize("arch,shape,multi", [
    ("stablelm-3b", "train_4k", False),
    ("gemma3-1b", "long_500k", True),
])
def test_dryrun_cell(arch, shape, multi, subproc):
    out = subproc(_CELL_CODE.format(arch=arch, shape=shape, multi=multi),
                  timeout=300)
    r = json.loads(out.split("RECORD ", 1)[1])
    assert set(r) == _RECORD_KEYS
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "peak_bytes"}
    roof = r["roofline"]
    assert set(roof) == _ROOFLINE_KEYS
    assert r["chips"] == roof["chips"] == (512 if multi else 256)
    assert roof["flops_global"] > 0 and roof["coll_bytes_global"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert 0 < roof["useful_ratio"] <= 1
    coll = roof["coll_breakdown"]
    assert coll["torch_flops_global"] > 0 and "bytes_naive_global" in coll
    assert not any(k.startswith("xla_") for k in coll)
    assert r["memory"]["temp_bytes"] > 0
    assert r["memory"]["peak_bytes"] == r["memory"]["temp_bytes"] + \
        r["memory"]["argument_bytes"]


_FAIL_CODE = """
import json, sys
from repro_torch.launch import dryrun
r = dryrun.run_cell("stablelm-3b", "train_4k", False,
                    cfg_overrides={"n_kv_heads": 3})
assert r["status"] == "FAIL" and r["error"], r
assert dryrun.run_cell("stablelm-3b", "long_500k", False)["status"] == "skip"
dryrun.run_cell = lambda arch, shape, multi: dict(r, arch=arch, shape=shape)
sys.argv = ["dryrun", "--arch", "stablelm-3b", "--shape", "train_4k",
            "--out", OUT]
try:
    dryrun.main()
except SystemExit as e:
    assert e.code == 1, e.code
else:
    raise AssertionError("main returned")
assert json.load(open(OUT))[0]["status"] == "FAIL"
print("FAIL-OK", r["error"])
"""


def test_failing_cell_is_recorded_and_main_exits_1(tmp_path, subproc):
    """A cell that raises (here 32 query heads over 3 KV heads) is
    recorded as ``FAIL`` with its error, and ``main`` writes the records
    and exits 1."""
    out = subproc(f"OUT = {str(tmp_path / 'cells.json')!r}\n" + _FAIL_CODE,
                  timeout=300)
    assert "FAIL-OK" in out
    assert "[dryrun]" in out and "FAIL" in out
