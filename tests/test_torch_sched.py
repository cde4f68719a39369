"""The port's optimizer pipeline (``repro_torch.sched`` and
``repro_torch.launch.optimize``) against the JAX package's on the CPU.

- Lowering: for the seven registered kernels at every ``CONFIGS`` entry
  and the scenarios below, the same instruction count, opcodes,
  tile/group/predicate structure, operand text and ``-O3`` order, control
  codes and cycles.
  Operand text is compared after normalizing LDV ``[UR2+...]`` addresses
  and long SMOV immediates: the reference derives them from Python's
  per-process salted ``hash()``, the port from a stable digest (it gives
  the same listing in every process, which one test checks).
- The session: ``autotune`` choices, ``probabilistic_test`` verdicts, the
  greedy and seeded random searches (best cycles 8294 -> 8289 and
  8275 -> 8271), cache v3 indexes crossing both ways, the launcher's
  output lines (the pair, qwen1.5-4b's 18-cell and mamba2-1.3b's 16-cell
  ``--arch`` fleets), and
  a supervised campaign's ``FailureLedger`` resume and skip semantics, all
  equal to the reference's.  The PPO strategy's own parity tests are in
  ``tests/test_torch_ppo.py``.
"""

import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.isa import program_text as jtext
from repro.kernels import get_kernel as jget_kernel
from repro.launch import optimize as joptimize
from repro.sched import FailureLedger as JLedger
from repro.sched import FastTimingBackend as JFast
from repro.sched import OptimizationSession as JSession
from repro.sched import OptimizeRequest as JRequest
from repro.sched import ResilientBackend as JResilient
from repro.sched import RetryPolicy as JRetry
from repro.sched import autotune as jautotune
from repro.sched import lower as jlower
from repro.sched import make_budgeted_strategy as jbudgeted
from repro.sched import probabilistic_test as jverify
from repro.sched import schedule as jschedule
from repro.sched.cache import ScheduleCache as JCache
from repro.sched.scenario import Scenario as JScenario
from repro.sched.scenario import build_spec as jbuild_spec
from repro.sched.scenario import get_target as jget_target
from repro.sched.scenario import nearest_bucket as jnearest
from repro.sched.spec import KernelSpec as JSpec
from repro.sched.spec import TileIO as JTile
from repro_torch.core import FaultSpec, FaultyMachine, Machine
from repro_torch.core import schedule_fingerprint as tfingerprint
from repro_torch.core.isa import program_text as ttext
from repro_torch.core.parser import parse_program as tparse
from repro_torch.kernels import (KERNELS, KernelDef, get_kernel,
                                 register_kernel, unregister_kernel)
from repro_torch.launch import optimize as toptimize
from repro_torch.launch.specs import kernel_fleet
from repro_torch.sched import (FailureLedger, FastTimingBackend,
                               OptimizationSession, OptimizeRequest,
                               ResilientBackend,
                               RetryPolicy, autotune, lower,
                               make_budgeted_strategy, probabilistic_test,
                               schedule, schedule_plan)
from repro_torch.sched.cache import ScheduleCache
from repro_torch.sched.resilience import cell_key
from repro_torch.sched.scenario import Scenario, build_spec, get_target
from repro_torch.sched.scenario import nearest_bucket as tnearest
from repro_torch.sched.spec import KernelSpec, TileIO

PAIR = ("matmul_leakyrelu", "bmm")
# the registry, in the reference's order
FLEET = ("matmul_leakyrelu", "fused_ff", "bmm", "flash_attention", "softmax",
         "rmsnorm", "ssd")

# (instructions, -O3 cycles) of the reference's listing at each config
GATE = {
    ("matmul_leakyrelu", (128, 128, 128)): (136, 8294),
    ("matmul_leakyrelu", (128, 128, 64)): (100, 4172),
    ("matmul_leakyrelu", (64, 128, 128)): (100, 6863),
    ("matmul_leakyrelu", (128, 256, 64)): (157, 8441),
    ("matmul_leakyrelu", (256, 128, 64)): (157, 8510),
    ("bmm", (128, 128, 128)): (110, 8275),
    ("bmm", (128, 128, 64)): (74, 4153),
    ("bmm", (64, 64, 128)): (65, 3379),
    ("bmm", (256, 64, 64)): (86, 6007),
}
# (instructions, -O3 cycles) of the reference's listing at each CONFIGS
# entry of the other five kernels, in CONFIGS order
FLEET_GATE = {
    "fused_ff": [(173, 12550), (119, 5856), (152, 10462), (171, 9631)],
    "flash_attention": [(185, 5124), (323, 9877), (307, 6488),
                        (241, 10679)],
    "softmax": [(518, 15852), (678, 34040), (678, 34040), (518, 15852)],
    "rmsnorm": [(270, 9561), (478, 15692), (479, 15868), (478, 15692)],
    "ssd": [(161, 3945), (287, 11277), (179, 4291)],
}
# tests/test_scenarios.py's workload points (None: the legacy single
# point); they give matmul_leakyrelu 2 to 8 unrolled steps and two dtypes
SCENARIOS = [None, "8x4096", "12x3000xbfloat16xhalf", "64x32768xbf16xhalf",
             "8x32768xf32xlow", "256x4096", "100x32768xbf16xhalf"]


def _scen(pkg_scenario, text):
    return None if text is None else pkg_scenario.parse(text)


def _norm(text):
    """Listing text without the hash-derived LDV addresses and long SMOV
    immediates."""
    text = re.sub(r"(LDV R\d+, \[UR2\+)0x[0-9a-f]+\]", r"\1*]", text)
    return re.sub(r"(SMOV R\d+, )0x[0-9a-f]+", r"\1*", text)


def _structure(program):
    return [(i.opcode, i.pred, i.tile, i.group, i.defs, i.uses)
            for i in program]


def _pair_listings(name, cfg, scen_text):
    jspec = jbuild_spec(jget_kernel(name).make_spec, cfg,
                        _scen(JScenario, scen_text))
    tspec = build_spec(get_kernel(name).make_spec, cfg,
                       _scen(Scenario, scen_text))
    return jlower(jspec), lower(tspec)


# ---------------------------------------------------------------------------
# lowering and the -O3 scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scen_text", SCENARIOS)
@pytest.mark.parametrize("name,blocks", sorted(GATE))
def test_lowering_and_o3_match_reference(name, blocks, scen_text):
    cfg = dict(zip(("bm", "bn", "bk"), blocks))
    jl, tl = _pair_listings(name, cfg, scen_text)
    assert len(tl.program) == len(jl.program)
    assert _structure(tl.program) == _structure(jl.program)
    assert _norm(ttext(tl.program)) == _norm(jtext(jl.program))
    jo, to = jschedule(jl), schedule(tl)
    assert [dataclasses.asdict(i.ctrl) for i in to] == \
        [dataclasses.asdict(i.ctrl) for i in jo]
    assert _norm(ttext(to)) == _norm(jtext(jo))
    cycles = Machine().run(to).cycles
    from repro.core import Machine as JMachine
    assert cycles == JMachine().run(jo).cycles
    if scen_text is None:
        assert (len(to), cycles) == GATE[name, blocks]


@pytest.mark.parametrize("scen_text", SCENARIOS)
@pytest.mark.parametrize("name,index", [(n, i) for n in FLEET_GATE
                                        for i in range(len(FLEET_GATE[n]))])
def test_fleet_lowering_and_o3_match_reference(name, index, scen_text):
    """The A5 gate on the other five kernels: rmsnorm (``jnp.mean`` as
    reduce_sum and div by a literal), fused_ff (``jax.nn.silu`` through
    the call fallback), flash_attention (``k.T``, an epilogue over two
    accumulators), softmax (one step per row tile) and ssd (``jnp.cumsum``
    through the call fallback, indexing as free views)."""
    cfg = get_kernel(name).configs[index]
    assert cfg == jget_kernel(name).configs[index]
    jl, tl = _pair_listings(name, cfg, scen_text)
    assert _structure(tl.program) == _structure(jl.program)
    assert _norm(ttext(tl.program)) == _norm(jtext(jl.program))
    jo, to = jschedule(jl), schedule(tl)
    assert [dataclasses.asdict(i.ctrl) for i in to] == \
        [dataclasses.asdict(i.ctrl) for i in jo]
    assert _norm(ttext(to)) == _norm(jtext(jo))
    cycles = Machine().run(to).cycles
    from repro.core import Machine as JMachine
    assert cycles == JMachine().run(jo).cycles
    if scen_text is None:
        assert (len(to), cycles) == FLEET_GATE[name][index]


def test_listing_is_the_same_in_every_process():
    """The port's listing text (LDV addresses, SMOV immediates included)
    does not depend on PYTHONHASHSEED."""
    code = ("import hashlib\n"
            "from repro_torch.kernels import KERNELS\n"
            "from repro_torch.sched import lower, schedule\n"
            "from repro_torch.core.isa import program_text\n"
            "for name in ('matmul_leakyrelu', 'bmm'):\n"
            "    k = KERNELS[name]\n"
            "    text = program_text(schedule(lower(k.make_spec("
            "k.configs[0]))))\n"
            "    print(name, hashlib.sha256(text.encode()).hexdigest())\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    outs = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONPATH=src, PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 2
    here = {name: hashlib.sha256(ttext(schedule(lower(
        KERNELS[name].make_spec(KERNELS[name].configs[0])))).encode()
    ).hexdigest() for name in PAIR}
    assert outs[0] == "".join(f"{n} {h}\n" for n, h in here.items())


# (name, torch tile function, the jnp function it ports) for the mapped
# torch calls, on two (64, 64) f32 tiles
CALLS = [
    ("add", lambda a, b: (a + b,), lambda a, b: (a + b,)),
    ("radd", lambda a, b: (1.0 + a,), lambda a, b: (1.0 + a,)),
    ("sub", lambda a, b: (a - b,), lambda a, b: (a - b,)),
    ("rsub", lambda a, b: (1.0 - a,), lambda a, b: (1.0 - a,)),
    ("mul", lambda a, b: (a * 2.0,), lambda a, b: (a * 2.0,)),
    ("div", lambda a, b: (a / 2.0,), lambda a, b: (a / 2.0,)),
    ("rdiv", lambda a, b: (1.0 / a,), lambda a, b: (1.0 / a,)),
    ("neg", lambda a, b: (-a,), lambda a, b: (-a,)),
    ("maximum", lambda a, b: (torch.maximum(a, b),),
     lambda a, b: (jnp.maximum(a, b),)),
    ("minimum", lambda a, b: (torch.minimum(a, b),),
     lambda a, b: (jnp.minimum(a, b),)),
    ("exp", lambda a, b: (torch.exp(a),), lambda a, b: (jnp.exp(a),)),
    ("log", lambda a, b: (a.log(),), lambda a, b: (jnp.log(a),)),
    ("rsqrt", lambda a, b: (torch.rsqrt(a),),
     lambda a, b: (jax.lax.rsqrt(a),)),
    ("sqrt", lambda a, b: (torch.sqrt(a),), lambda a, b: (jnp.sqrt(a),)),
    ("sigmoid", lambda a, b: (torch.sigmoid(a),),
     lambda a, b: (jax.nn.sigmoid(a),)),
    ("tanh", lambda a, b: (torch.tanh(a),), lambda a, b: (jnp.tanh(a),)),
    ("abs", lambda a, b: (abs(a),), lambda a, b: (jnp.abs(a),)),
    ("compare", lambda a, b: (a < b, a == b, a > 0),
     lambda a, b: (a < b, a == b, a > 0)),
    ("sum", lambda a, b: (a.sum(-1, keepdim=True) * b,),
     lambda a, b: (jnp.sum(a, axis=-1, keepdims=True) * b,)),
    ("amax", lambda a, b: (torch.exp(a - a.amax(-1, keepdim=True)),),
     lambda a, b: (jnp.exp(a - jnp.max(a, axis=-1, keepdims=True)),)),
    ("amin", lambda a, b: (a.amin(0),), lambda a, b: (jnp.min(a, axis=0),)),
    ("views", lambda a, b: (a.t().reshape(32, 128).float() * 2.0,),
     lambda a, b: (a.T.reshape(32, 128).astype(jnp.float32) * 2.0,)),
    ("where", lambda a, b: (torch.where(a > b, a, b * 0.5),),
     lambda a, b: (jnp.where(a > b, a, b * 0.5),)),
    ("matmul_epilogue", lambda a, b: (torch.sigmoid(a @ b) * a,),
     lambda a, b: (jax.nn.sigmoid(a @ b) * a,)),
    ("batched_matmul", lambda a, b: (torch.matmul(a, b),),
     lambda a, b: (jnp.matmul(a, b),), (3, 256, 128), (3, 128, 256)),
    ("mean", lambda a, b: (torch.mean(a * a, -1, keepdim=True) * b,),
     lambda a, b: (jnp.mean(a * a, axis=-1, keepdims=True) * b,)),
    ("silu", lambda a, b: (torch.nn.functional.silu(a) * b,),
     lambda a, b: (jax.nn.silu(a) * b,)),
    ("attribute_T", lambda a, b: (a @ b.T,), lambda a, b: (a @ b.T,)),
]


@pytest.mark.parametrize("case", CALLS, ids=[c[0] for c in CALLS])
def test_lowering_of_each_mapped_call_matches_reference(case):
    """Each torch call the lowering maps gives the listing the reference
    gives its jnp counterpart (so the table holds beyond the pair)."""
    name, tfn, jfn, *shapes = case
    tiles = list(zip("ab", shapes or [(64, 64), (64, 64)]))
    jl = jlower(JSpec(name, jfn, [JTile(*t) for t in tiles],
                      [JTile("y", (64, 64))]))
    tl = lower(KernelSpec(name, tfn, [TileIO(*t) for t in tiles],
                          [TileIO("y", (64, 64))]))
    assert _structure(tl.program) == _structure(jl.program)
    assert _norm(ttext(tl.program)) == _norm(jtext(jl.program))
    assert _norm(ttext(schedule(tl))) == _norm(jtext(jschedule(jl)))


def test_unmapped_torch_call_raises():
    spec = KernelSpec("odd", lambda a: (a.cumprod(0),), [TileIO("a", (8, 8))],
                      [TileIO("y", (8, 8))])
    with pytest.raises(NotImplementedError, match="no TSASS mapping"):
        lower(spec)


# indexing with a tensor: the reference traces it to gather, not a view
GATHERS = [
    ("mask", lambda a, b: (a[b > 0],)),
    ("int_tensor", lambda a, b: (a[b.long()],)),
    ("tuple_with_tensor", lambda a, b: (a[:, b[0].long()],)),
]


@pytest.mark.parametrize("case", GATHERS, ids=[c[0] for c in GATHERS])
def test_tensor_indexing_raises(case):
    _, fn = case
    spec = KernelSpec("gather", fn, [TileIO("a", (8, 8)), TileIO("b", (8,))],
                      [TileIO("y", (8, 8))])
    with pytest.raises(NotImplementedError, match="'getitem' with the index"):
        lower(spec)


# ---------------------------------------------------------------------------
# scenarios, autotune, probabilistic testing
# ---------------------------------------------------------------------------

def test_scenario_buckets_and_dispatch_match():
    texts = [s for s in SCENARIOS if s] + ["1x1", "5x4097", "128x32768"]
    jb = [JScenario.parse(t).bucket for t in texts]
    assert [Scenario.parse(t).bucket for t in texts] == jb
    for probe in texts + ["12x4096", "100x32768xf32xlow"]:
        assert tnearest(jb, Scenario.parse(probe)) == \
            jnearest(jb, JScenario.parse(probe))
        assert tnearest(jb[:2] + ["default"], probe) == \
            jnearest(jb[:2] + ["default"], probe)


@pytest.mark.parametrize("scen_text", [None, "256x4096", "8x32768xf32xlow"])
@pytest.mark.parametrize("name", FLEET)
def test_autotune_picks_the_same_config(name, scen_text):
    got = autotune(get_kernel(name).make_spec, get_kernel(name).configs,
                   scenario=_scen(Scenario, scen_text))
    want = jautotune(jget_kernel(name).make_spec,
                     jget_kernel(name).configs,
                     scenario=_scen(JScenario, scen_text))
    assert got.best.config == want.best.config
    assert [(e.config, e.cycles) for e in got.entries] == \
        [(e.config, e.cycles) for e in want.entries]


def _mangled(program, limit=8):
    """Listings with one producer swapped with its first consumer (the
    masking bug probabilistic testing exists to catch), for the first
    ``limit`` producers that have one."""
    for i, ins in enumerate(program):
        j = next((j for j in range(i + 1, len(program))
                  if (ins.defs or frozenset()) & (program[j].uses
                                                  or frozenset())), None)
        if j is None:
            continue
        bad = list(program)
        bad[i], bad[j] = bad[j], bad[i]
        yield bad
        limit -= 1
        if not limit:
            return


@pytest.mark.parametrize("name", PAIR)
def test_probabilistic_test_verdicts_match(name, kernel_programs):
    prog = kernel_programs[name]
    mine = tparse(jtext(prog))
    verdicts = []
    for optimized in [prog, *_mangled(prog)]:
        got = probabilistic_test(mine, tparse(jtext(optimized)), n_seeds=3)
        want = jverify(prog, optimized, n_seeds=3)
        assert (got.ok, got.failures, got.n_seeds) == \
            (want.ok, want.failures, want.n_seeds)
        verdicts.append(want.ok)
    assert verdicts[0] and not all(verdicts)      # a failing reordering


# ---------------------------------------------------------------------------
# the session: searches, caches crossing both ways, deploy
# ---------------------------------------------------------------------------

def _best(results, text):
    return {r.kernel: (r.config, r.artifact.baseline_cycles,
                       r.artifact.optimized_cycles,
                       _norm(text(r.artifact.program)))
            for r in results}


@pytest.mark.parametrize("strategy", ["greedy", "random"])
def test_search_matches_reference(strategy, tmp_path, stall_db):
    kw = dict(timesteps=64, episode_length=16)
    mine = OptimizationSession(
        strategy=make_budgeted_strategy(strategy, **kw),
        cache_dir=str(tmp_path / "t"), stall_db=stall_db)
    ref = JSession(strategy=jbudgeted(strategy, **kw),
                   cache_dir=str(tmp_path / "j"), stall_db=stall_db)
    got = _best(mine.optimize_many(PAIR), ttext)
    want = _best(ref.optimize_many(PAIR), jtext)
    assert got == want
    if strategy == "greedy":
        assert {k: v[1:3] for k, v in got.items()} == \
            {"matmul_leakyrelu": (8294, 8289), "bmm": (8275, 8271)}


def test_cache_v3_index_crosses_both_ways(tmp_path, stall_db):
    """An index (default bucket and a scenario bucket) written by either
    package loads in the other, with the same configs, cycles and
    listing."""
    scen = "256x4096"
    for writer, reader in (("t", "j"), ("j", "t")):
        d = str(tmp_path / writer)
        if writer == "t":
            s = OptimizationSession(strategy="greedy", cache_dir=d,
                                    stall_db=stall_db, verify_seeds=2)
            s.optimize("matmul_leakyrelu")
            s.optimize(OptimizeRequest(
                kernel="matmul_leakyrelu", scenario=Scenario.parse(scen)))
        else:
            s = JSession(strategy="greedy", cache_dir=d, stall_db=stall_db,
                         verify_seeds=2)
            s.optimize("matmul_leakyrelu")
            s.optimize(JRequest(
                kernel="matmul_leakyrelu", scenario=JScenario.parse(scen)))
        caches = {"t": ScheduleCache(d), "j": JCache(d)}
        for sc in (None, scen):
            arts = {}
            for pkg, c in caches.items():
                arts[pkg] = (c.lookup_best("matmul_leakyrelu") if sc is None
                             else c.dispatch("matmul_leakyrelu",
                                             (Scenario if pkg == "t"
                                              else JScenario).parse(sc)))
            a, b = arts[writer], arts[reader]
            assert (a.config, a.scenario, a.baseline_cycles,
                    a.optimized_cycles, a.meta) == \
                (b.config, b.scenario, b.baseline_cycles,
                 b.optimized_cycles, b.meta)
            text = jtext if writer == "j" else ttext
            other = ttext if reader == "t" else jtext
            assert other(b.program) == text(a.program)
        with open(os.path.join(d, "tpu-tsass-v1", "matmul_leakyrelu",
                               "index.json")) as f:
            assert json.load(f)["version"] == 3


def test_deploy_and_schedule_plan_measure_nothing(tmp_path, stall_db,
                                                  monkeypatch):
    d = str(tmp_path / "cache")
    session = OptimizationSession(strategy="greedy", cache_dir=d,
                                  stall_db=stall_db, verify_seeds=2)
    session.optimize_many(["bmm"])
    calls = []
    for attr in ("run", "time"):
        monkeypatch.setattr(Machine, attr,
                            lambda *a, _n=attr, **k: calls.append(_n))
    from repro_torch.sched import session as session_mod
    monkeypatch.setattr(session_mod.autotune_mod, "autotune",
                        lambda *a, **k: calls.append("autotune"))
    fresh = OptimizationSession(strategy="greedy", cache_dir=d)
    art = fresh.deploy("bmm")
    assert (art.baseline_cycles, art.optimized_cycles) == (8275, 8271)
    plan = schedule_plan(["bmm", "matmul_leakyrelu"], cache_dir=d)
    assert plan["bmm"].optimized_cycles == 8271
    assert plan["matmul_leakyrelu"] is None          # never tuned: -O3
    with pytest.raises(FileNotFoundError):
        schedule_plan(["matmul_leakyrelu"], cache_dir=d, on_missing="raise")
    with pytest.raises(FileNotFoundError):
        fresh.deploy("matmul_leakyrelu")
    assert calls == []


def test_unported_strategies_and_registry(tmp_path, stall_db, monkeypatch):
    """PPO runs (tests/test_torch_ppo.py holds it against the reference);
    the cost-model strategies, beam and lookahead, build at the
    launcher's budget and reach the reference's cycles on bmm
    (tests/test_torch_costmodel.py holds their walks against the
    reference's); the default strategy, ppo, needs a card unless asked
    for the CPU; the
    registry holds the seven kernels in the reference's order, ``ssd``
    last, each with its Hopper kernel and its plain version, and an
    unknown name raises ``KeyError`` listing them."""
    ppo = make_budgeted_strategy("ppo", timesteps=64, episode_length=8,
                                 device="cpu")
    assert ppo.name == "ppo" and ppo.ppo.total_timesteps == 64
    res = OptimizationSession(strategy=ppo, cache_dir=str(tmp_path),
                              stall_db=stall_db,
                              verify_seeds=2).optimize("bmm")
    assert res.strategy == "ppo" and res.game is not None
    assert res.artifact.optimized_cycles <= res.artifact.baseline_cycles
    bmm = schedule(lower(get_kernel("bmm").make_spec(
        get_kernel("bmm").configs[0])))
    for name, best in (("beam", 8268), ("lookahead", 8270)):
        strategy = make_budgeted_strategy(name)
        assert strategy.name == f"{name}-oracle"
        assert strategy.max_measurements == 8192
        out = strategy.search(bmm, stall_db=stall_db,
                              backend=FastTimingBackend(), owner="bmm")
        jout = jbudgeted(name).search(
            jschedule(jlower(jget_kernel("bmm").make_spec(
                jget_kernel("bmm").configs[0]))),
            stall_db=stall_db, backend=JFast(), owner="bmm")
        assert (out.baseline_cycles, out.best_cycles) == (8275, best) == \
            (jout.baseline_cycles, jout.best_cycles)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OptimizationSession(cache_dir=str(tmp_path / "d"),
                            stall_db=stall_db).optimize("bmm")
    assert list(KERNELS) == list(FLEET)
    for name in FLEET:
        kdef = get_kernel(name)
        assert kdef.kernel_fn is not None and kdef.ref_fn is not None
        assert kdef.configs == jget_kernel(name).configs
    with pytest.raises(KeyError, match="registered kernels"):
        get_kernel("ssd_v2")
    alias = register_kernel(KernelDef("bmm_alias", get_kernel("bmm").make_spec,
                                      get_kernel("bmm").configs))
    try:
        assert get_kernel("bmm_alias") is alias
    finally:
        unregister_kernel("bmm_alias")
    assert "bmm_alias" not in KERNELS


def test_kernel_fleet_matches_reference():
    from repro.configs import get_config as jget_config
    from repro.launch.specs import kernel_fleet as jkernel_fleet
    from repro_torch.configs import get_config
    for arch in ("stablelm-3b", "mamba2-1.3b", "qwen1.5-4b"):
        got = kernel_fleet(get_config(arch, reduced=True))
        want = jkernel_fleet(jget_config(arch, reduced=True))
        assert [(n, s.bucket) for n, s in got] == \
            [(n, s.bucket) for n, s in want]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["optimize", *argv])
    module.main()
    out = capsys.readouterr().out
    # wall times and cache paths differ between the two runs
    out = re.sub(r", [0-9.]+s\)", ", *s)", out)
    return out.replace(argv[argv.index("--cache-dir") + 1], "<cache>")


def test_launcher_output_matches_reference(tmp_path, monkeypatch, capsys):
    for extra in ([], ["--deploy"], []):
        args = ["matmul_leakyrelu", "bmm", "--strategy", "greedy"] + extra
        got = _run_main(toptimize, args + ["--cache-dir", str(tmp_path / "t")],
                        monkeypatch, capsys)
        want = _run_main(joptimize, args + ["--cache-dir",
                                            str(tmp_path / "j")],
                         monkeypatch, capsys)
        assert got == want
    assert "[optimize] matmul_leakyrelu: 8294 -> 8289 cycles" in want \
        or "[optimize] matmul_leakyrelu: cached" in want


@pytest.mark.parametrize("strategy,cycles", [
    ("beam", ("8294 -> 8286", "8275 -> 8268")),
    ("lookahead", ("8294 -> 8288", "8275 -> 8270"))])
def test_guided_launcher_output_matches_reference(tmp_path, monkeypatch,
                                                  capsys, strategy, cycles):
    """``--strategy beam|lookahead`` (the oracle-ranked walks) prints the
    reference command's lines, shared-memo line included, and the
    reference's ``--deploy`` reads the port's cache back."""
    args = [*PAIR, "--strategy", strategy]
    port_cache = ["--cache-dir", str(tmp_path / "t")]
    for extra in ([], ["--deploy"]):
        got = _run_main(toptimize, args + extra + port_cache, monkeypatch,
                        capsys)
        want = _run_main(joptimize, args + extra + [
            "--cache-dir", str(tmp_path / "j")], monkeypatch, capsys)
        assert got == want
    assert _run_main(joptimize, args + ["--deploy"] + port_cache,
                     monkeypatch, capsys) == got
    for name, c in zip(PAIR, cycles):
        assert f"[optimize] {name}: cached config " in got and \
            f" {c} cycles" in got


def test_arch_fleet_launcher_matches_reference(tmp_path, monkeypatch,
                                               capsys):
    """``--arch qwen1.5-4b --strategy greedy`` (the port with ``--device
    cpu``) prints the reference's 18 cells — 6 kernels x 3 buckets, with
    their cycles — and ``--deploy`` reads back the same configs."""
    args = ["--arch", "qwen1.5-4b", "--strategy", "greedy"]
    for extra in ([], ["--deploy"]):
        got = _run_main(toptimize, args + extra + [
            "--device", "cpu", "--cache-dir", str(tmp_path / "t")],
            monkeypatch, capsys)
        want = _run_main(joptimize, args + extra + [
            "--cache-dir", str(tmp_path / "j")], monkeypatch, capsys)
        assert got == want
        cells = [line for line in got.splitlines()
                 if re.match(r"\[optimize\] \w+@b", line)]
        assert len(cells) == 18
    want_cycles = {"matmul_leakyrelu": "35519 -> 35504",
                   "fused_ff": "9631 -> 9121", "rmsnorm": "29371 -> 29349",
                   "flash_attention": "6488 -> 6463",
                   "softmax": "66060 -> 66060", "bmm": "8275 -> 8271"}
    configs = {"matmul_leakyrelu": {"bm": 128, "bn": 256, "bk": 64},
               "fused_ff": {"bm": 256, "bn": 128, "bk": 64},
               "rmsnorm": {"br": 8, "cols": 2048},
               "flash_attention": {"bq": 256, "bk": 128, "d": 64},
               "softmax": {"br": 8, "cols": 4096},
               "bmm": {"bm": 128, "bn": 128, "bk": 128}}
    for line in cells:                     # the --deploy lines
        name = line.split()[1].split("@")[0]
        assert f"cached config {configs[name]} {want_cycles[name]} " in line


def test_ssm_fleet_launcher_matches_reference(tmp_path, monkeypatch,
                                              capsys):
    """``--arch mamba2-1.3b --strategy greedy`` prints the reference's 16
    cells — 4 kernels (``ssd`` among them) x 4 buckets, with their
    cycles — and its campaign and shared-memo lines; ``--deploy`` reads
    back the same configs."""
    args = ["--arch", "mamba2-1.3b", "--strategy", "greedy"]
    for extra in ([], ["--deploy"]):
        got = _run_main(toptimize, args + extra + [
            "--device", "cpu", "--cache-dir", str(tmp_path / "t")],
            monkeypatch, capsys)
        want = _run_main(joptimize, args + extra + [
            "--cache-dir", str(tmp_path / "j")], monkeypatch, capsys)
        assert got == want
        cells = [line for line in got.splitlines()
                 if re.match(r"\[optimize\] \w+@b", line)]
        assert len(cells) == 16
        if not extra:
            assert "[optimize] ssd@b1_s524288_f32_low: 3945 -> 3943 cycles" \
                in got
            assert "[optimize] shared memo: 7399 entries, 30017/37416 hits " \
                "(80.2%), 0 cross-kernel" in got
    assert "[optimize] ssd@b256_s4096_f32_full: cached config {'chunk': 64, " \
        "'p': 64, 'n': 128} 3945 -> 3943 cycles" in got


def test_launcher_fails_fast_on_unported_paths(tmp_path, monkeypatch,
                                              capsys):
    """The default strategy, ppo, needs a card and says so before any
    search unless ``--device cpu`` asks for the CPU; the cost-model
    strategies, beam and lookahead, run on the host without a card and
    print the reference's cycles on bmm."""
    base = ["--cache-dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["optimize", "bmm", *base])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toptimize.main()                             # --strategy ppo default
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           toptimize.LEDGER_FILENAME))
    for name, cycles in (("beam", "8275 -> 8268"),
                         ("lookahead", "8275 -> 8270")):
        monkeypatch.setattr(sys, "argv", [
            "optimize", "bmm", "--strategy", name, "--cache-dir",
            str(tmp_path / name)])
        toptimize.main()
        assert f"[optimize] bmm: {cycles} cycles (1.001x, {name}-oracle, " \
            in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a supervised, resumable campaign with faults (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def _campaign(pkg, tmp_path, stall_db):
    """One package's campaign over the pair x 2 scenarios x 2 targets with
    20% transients and an always-crashing cell (matmul_leakyrelu at
    256x4096 on tpu-tsass-v1: the schedules only that workload point
    autotunes crash), run three times against one ledger: per-cell
    outcomes of each pass."""
    if pkg == "t":
        mod, Sess, Fast, Res, Retry, Ledger, budget, Spec, Faulty = (
            toptimize, OptimizationSession, FastTimingBackend,
            ResilientBackend, RetryPolicy, FailureLedger,
            make_budgeted_strategy, FaultSpec, FaultyMachine)
        tgt, get, fingerprint, build = (get_target, get_kernel, tfingerprint,
                                        lambda *a: schedule(lower(
                                            build_spec(*a))))
    else:
        from repro.core import FaultSpec as Spec
        from repro.core import FaultyMachine as Faulty
        from repro.core import schedule_fingerprint as fingerprint
        mod, Sess, Fast, Res, Retry, Ledger, budget = (
            joptimize, JSession, JFast, JResilient, JRetry, JLedger,
            jbudgeted)
        tgt, get = jget_target, jget_kernel
        build = lambda *a: jschedule(jlower(jbuild_spec(*a)))  # noqa: E731
    scens = mod.parse_scenarios("8x4096,256x4096")
    kd = get("matmul_leakyrelu")

    def fps_at(scen):
        # a listing's fingerprint covers its hash-derived text, so each
        # package pins its own listings
        return {fingerprint(build(kd.make_spec, cfg, scen))
                for cfg in kd.configs}

    crash_fps = fps_at(scens[1]) - fps_at(scens[0])
    assert crash_fps
    reqs = mod.campaign_requests([(n, s) for n in PAIR for s in scens],
                                 [tgt("tpu-tsass-v1"), tgt("tpu-tsass-v2")])
    spec = Spec(seed=5, transient_rate=0.2, crash_fingerprints=crash_fps)
    backend = Res(Fast(lambda: Faulty(spec)), policy=Retry(max_retries=8))
    session = Sess(backend=backend,
                   strategy=budget("random", timesteps=16, episode_length=8),
                   cache_dir=str(tmp_path / pkg), stall_db=stall_db,
                   verify_seeds=2)
    path = str(tmp_path / pkg / "campaign_state.json")
    ledger = Ledger(path)
    passes = []
    for _ in range(3):
        results = session.optimize_many(reqs, ledger=ledger, max_retries=1)
        passes.append({session._cell_key(r): (
            o.ok, getattr(o, "error_type", None), getattr(o, "attempts", 0),
            getattr(o, "skipped", False), getattr(o, "from_cache", None),
            o.artifact.optimized_cycles if o.ok else None)
            for r, o in zip(reqs, results)})
    return passes, path


def test_supervised_campaign_ledger_matches_reference(tmp_path, stall_db):
    got, path = _campaign("t", tmp_path, stall_db)
    want, _ = _campaign("j", tmp_path, stall_db)
    assert got == want
    crash = cell_key("matmul_leakyrelu", Scenario.parse("256x4096"),
                     get_target("tpu-tsass-v1"))
    first, second, third = got
    assert [c for c, o in first.items() if not o[0]] == [crash]
    assert first[crash][1:4] == ("HardFault", 1, False)
    assert second[crash][1:4] == ("HardFault", 2, False)
    assert third[crash][2:4] == (2, True)
    assert all(o[0] and o[4] for c, o in second.items() if c != crash)
    # the ledger file the port wrote is one the reference reads
    assert JLedger(path).attempts(crash) == 2
    assert FailureLedger(path).attempts(crash) == 2
