"""The port's ``repro_torch.core`` against the JAX package's ``repro.core``
on the CPU: the TSASS parser and static analysis, the simulated machine
(the oracle and the timing-only path), the schedule timer, the stall-table
microbenchmarks, the seeded fault channel and the assembly game.

Every module here is a numpy copy of its reference, so every check is
bit-exact: the same listings (the reference's ``-O3`` listings of all
seven kernels, the ``kernel_programs`` fixture, crossing as TSASS text),
the same seeded random legal reorderings of them (random walks of the
reference's masked game), and the same seeded action sequences."""

import dataclasses

import numpy as np
import pytest

from repro.core import AssemblyGame as JGame
from repro.core import FaultSpec as JFaultSpec
from repro.core import FaultyMachine as JFaultyMachine
from repro.core import Machine as JMachine
from repro.core import analysis as janalysis
from repro.core import embedding as jembedding
from repro.core import microbench as jmicro
from repro.core import timing as jtiming
from repro.core.faults import schedule_fingerprint as jfingerprint
from repro.core.isa import program_text as jtext
from repro.core.machine import dataflow_reference as jdataflow
from repro_torch.core import AssemblyGame as TGame
from repro_torch.core import FaultSpec as TFaultSpec
from repro_torch.core import FaultyMachine as TFaultyMachine
from repro_torch.core import Machine as TMachine
from repro_torch.core import analysis as tanalysis
from repro_torch.core import embedding as tembedding
from repro_torch.core import microbench as tmicro
from repro_torch.core import timing as ttiming
from repro_torch.core.faults import schedule_fingerprint as tfingerprint
from repro_torch.core.isa import program_text as ttext
from repro_torch.core.machine import dataflow_reference as tdataflow
from repro_torch.core.parser import parse_program as tparse

KERNEL_NAMES = ["matmul_leakyrelu", "fused_ff", "bmm", "flash_attention",
                "softmax", "rmsnorm", "ssd"]


def _port(program):
    """A reference listing as the port's instructions (through its text)."""
    return tparse(jtext(program))


def _reorderings(program, stall_db, n_walks=3, steps=24):
    """Seeded random legal reorderings: masked random walks of the
    reference's game, each from the listing itself."""
    env = JGame(program, stall_db=stall_db, episode_length=steps)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_walks):
        env.reset()
        for _ in range(steps):
            actions = env.valid_actions()
            if not actions:
                break
            _, _, done, _ = env.step(int(rng.choice(actions)))
            if done:
                break
        out.append([ins.copy() for ins in env.program])
    return out


@pytest.fixture(scope="module")
def port_stall_db():
    return tmicro.build_stall_table()


def test_stall_table_and_clock_estimate_match(stall_db, port_stall_db):
    assert port_stall_db == stall_db
    for seed in (1, 2):
        assert tmicro.build_stall_table(machine=TMachine(seed=seed)) == \
            jmicro.build_stall_table(machine=JMachine(seed=seed))
    for op, n in (("SADD", 16), ("VMUL", 8)):
        assert tmicro.clock_based_estimate(op, n) == \
            jmicro.clock_based_estimate(op, n)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_listing_roundtrip_and_analysis_match(name, stall_db, port_stall_db,
                                              kernel_programs):
    prog = kernel_programs[name]
    mine = _port(prog)
    assert ttext(mine) == jtext(prog)
    assert ttext(tparse(ttext(mine))) == jtext(prog)
    for a, b in zip(mine, prog):
        assert (a.opcode, a.operands, a.pred, a.tile, a.group, a.defs,
                a.uses) == (b.opcode, b.operands, b.pred, b.tile, b.group,
                            b.defs, b.uses)
        assert dataclasses.asdict(a.ctrl) == dataclasses.asdict(b.ctrl)
    got = tanalysis.analyze(mine, port_stall_db)
    want = janalysis.analyze(prog, stall_db)
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name
    assert got.resolution_fractions() == want.resolution_fractions()
    np.testing.assert_array_equal(tembedding.embed_program(mine, got),
                                  jembedding.embed_program(prog, want))


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_machine_bit_exact_on_listings_and_reorderings(name, stall_db,
                                                       kernel_programs):
    prog = kernel_programs[name]
    for variant in [prog] + _reorderings(prog, stall_db):
        mine = _port(variant)
        for seed in (0, 3):
            got = TMachine().run(mine, input_seed=seed)
            want = JMachine().run(variant, input_seed=seed)
            assert got.cycles == want.cycles
            assert got.outputs == want.outputs
            assert got.counters == want.counters
            assert got.reg_values == want.reg_values
            assert tdataflow(mine, input_seed=seed) == \
                jdataflow(variant, input_seed=seed)
        assert TMachine().time(mine) == JMachine().time(variant) \
            == want.cycles
        assert TMachine().issue_times(mine) == JMachine().issue_times(variant)
    # a noisy machine draws the same stream through run and time
    tm, jm = TMachine(noise=0.05, seed=7), JMachine(noise=0.05, seed=7)
    mine = _port(prog)
    assert [tm.run(mine).cycles, tm.time(mine), tm.time(mine)] == \
        [jm.run(prog).cycles, jm.time(prog), jm.time(prog)]


@pytest.mark.parametrize("name", ["matmul_leakyrelu", "bmm", "ssd"])
def test_schedule_timer_matches(name, stall_db, kernel_programs):
    prog = kernel_programs[name]
    mine = _port(prog)
    n = len(prog)
    rng = np.random.default_rng(1)
    # a chain of adjacent swaps (what the game asks), then unrelated orders
    orders, ids = [], np.arange(n)
    for _ in range(12):
        p = int(rng.integers(1, n))
        ids = ids.copy()
        ids[p - 1], ids[p] = ids[p], ids[p - 1]
        orders.append(ids)
    orders += [rng.permutation(n) for _ in range(3)]
    tt = ttiming.ScheduleTimer(mine, checkpoint_every=8)
    jt = jtiming.ScheduleTimer(prog, checkpoint_every=8)
    for ids in orders:
        assert tt.time_ids(ids) == jt.time_ids(ids)
        assert tt.resumed_from == jt.resumed_from
    assert tt.time_many(orders[::-1]) == jt.time_many(orders[::-1])
    assert ttiming.time_program(mine) == jtiming.time_program(prog)


def test_faulty_machine_streams_match(kernel_programs):
    progs = [kernel_programs[n] for n in ("matmul_leakyrelu", "bmm",
                                          "rmsnorm")]
    crash = frozenset({jfingerprint(progs[2])})
    assert {tfingerprint(_port(p)) for p in progs} == \
        {jfingerprint(p) for p in progs}

    def stream(machine, programs):
        out = []
        for i in range(30):
            p = programs[i % len(programs)]
            try:
                out.append(machine.time(p) if i % 2 else machine.run(p).cycles)
            except Exception as e:          # noqa: BLE001 — the outcome
                out.append(type(e).__name__)
        return out, dict(machine.fault_counters)

    kw = dict(seed=5, transient_rate=0.3, outlier_rate=0.2,
              crash_fingerprints=crash)
    got = stream(TFaultyMachine(TFaultSpec(**kw)), [_port(p) for p in progs])
    want = stream(JFaultyMachine(JFaultSpec(**kw)), progs)
    assert got == want
    assert {"MeasureError", "HardFault"} <= set(want[0])


@pytest.mark.parametrize("name,kw", [
    ("matmul_leakyrelu", {}),
    ("bmm", {"hop_sizes": (1, 2)}),
    ("rmsnorm", {"warm_start": True}),
    ("flash_attention", {"use_fast_mask": False}),
])
def test_assembly_game_matches(name, kw, stall_db, port_stall_db,
                               kernel_programs):
    prog = kernel_programs[name]
    mine = TGame(_port(prog), stall_db=port_stall_db, episode_length=16,
                 **kw)
    ref = JGame(prog, stall_db=stall_db, episode_length=16, **kw)
    rng = np.random.default_rng(2)
    for episode in range(2):
        o1, o2 = mine.reset(), ref.reset()
        for key in ("state", "mask"):
            np.testing.assert_array_equal(o1[key], o2[key])
        for _ in range(16):
            actions = ref.valid_actions()
            assert mine.valid_actions() == actions
            if not actions:
                break
            a = int(rng.choice(actions))
            assert mine.probe_swap(mine.action_swap_pos(a)) == \
                ref.probe_swap(ref.action_swap_pos(a))
            (o1, r1, d1, i1), (o2, r2, d2, i2) = mine.step(a), ref.step(a)
            assert (r1, d1, i1.get("cycles")) == (r2, d2, i2.get("cycles"))
            for key in ("state", "mask"):
                np.testing.assert_array_equal(o1[key], o2[key])
            if d1:
                break
        assert (mine.best_cycles, mine.prev_cycles) == \
            (ref.best_cycles, ref.prev_cycles)
        assert ttext(mine.best_program) == jtext(ref.best_program)
