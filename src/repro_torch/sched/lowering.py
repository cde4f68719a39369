"""Lowering: KernelSpec -> TSASS dataflow listing.

Port of ``repro/sched/lowering.py``.  This is the "compile + disassemble
the cubin" stage of the paper's Fig. 2: the kernel's per-step tile
computation is traced to a graph, instructions are selected against the
TSASS ISA (matrix products -> MXU passes, elementwise/reduce -> VPU lanes,
transcendental -> slow VPU lanes), tile movement becomes grouped DMA
(CPYIN/CPYOUT, the LDGSTS/STG analogues) plus VMEM<->VREG staging
(LDV/STV), and address arithmetic becomes scalar-core instructions
feeding the DMA — the fixed-latency -> memory-instruction dependencies
the paper's analysis pass and Algorithm 1 revolve around.

The output is a *dataflow-ordered* listing with empty control codes; the
baseline list scheduler (:mod:`repro_torch.sched.baseline`, our ptxas -O3
stand-in) orders it and assigns barriers/stall counts.

Deliberate structural features carried over from real SASS kernels:
  * grouped consecutive DMA per tile (``grp=``) whose relative order is
    pinned (paper §3.5 "additional dependencies");
  * loop-invariant tiles loaded via prologue-defined address registers,
    producing denylist entries (§3.2);
  * predicated-off ``@!PT LDV`` boundary-check slots (§5.7.2, Fig. 13);
  * MXM bursts whose second operand earns a ``.reuse`` flag (§5.7.1, Fig. 9).

The tracer.  The reference traces a jnp tile function with
``jax.make_jaxpr``; here a torch tile function is traced with
``torch.fx.symbolic_trace`` and its tensors' shapes are propagated on the
``meta`` device.  ``symbolic_trace`` records each call as the source wrote
it — ``0.01 * acc`` is ``mul(0.01, acc)``, a literal first, as jax records
it — where ``make_fx`` would canonicalize to ``aten.mul.Tensor(acc,
0.01)``; the operand order decides the listing's text, so the port uses
the former.  Each torch call maps onto the jax primitive name the
reference's tables (``_ELTWISE_OP``, ``_VIEW_PRIMS``, ``_REDUCE_OP``)
are keyed by; a call with no mapping raises rather than guess.

Two traits of the reference as installed (jax 0.9) that the port keeps,
so that listings and cycles agree:
  * ``jnp.where``, ``jax.nn.silu`` and ``jnp.cumsum`` trace as calls named
    ``jit``, which ``_CALL_PRIMS`` (listing ``pjit``) does not walk into:
    the whole call lowers through the eltwise fallback, VADDs over its
    first two operands (``where``'s predicate and true value; ``silu``'s
    and ``cumsum``'s one operand);
  * literals are keyed by their f32 value (jax's weak-typed ``0`` and
    ``0.0`` are one literal), one register per distinct value, in order
    of first use.
The reference derives LDV addresses and long SMOV immediates from
Python's per-process salted ``hash()``; the port uses a ``hashlib``
digest, so its listing text is the same in every process.  Neither text
changes a cycle count: memory effects are keyed by tile tokens.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import warnings
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.fx

from repro_torch.core.isa import Control, Instruction
from repro_torch.core.parser import analyze_operands
from repro_torch.sched.spec import KernelSpec, TileIO

DMA_CHUNK = 4096       # bytes per CPYIN/CPYOUT instruction
LDV_CHUNK = 8192       # bytes per LDV/STV staging instruction
VPU_ELEMS = 2048       # elements per VPU instruction
MXU_DIM = 128          # systolic array edge

_ELTWISE_OP = {
    "add": "VADD", "sub": "VSUB", "mul": "VMUL", "div": "VRECIP",
    "max": "VMAX", "min": "VMAX", "exp": "VEXP", "exp2": "VEXP",
    "log": "VEXP", "rsqrt": "VRSQ", "sqrt": "VRSQ", "logistic": "VEXP",
    "tanh": "VEXP", "neg": "VSUB", "integer_pow": "VMUL", "pow": "VMUL",
    "abs": "VMAX", "sign": "VMAX", "select_n": "VADD", "concatenate": "VADD",
    "lt": "VMAX", "gt": "VMAX", "ge": "VMAX", "le": "VMAX", "eq": "VMAX",
    "ne": "VMAX", "and": "VADD", "or": "VADD", "xor": "VADD",
    "clamp": "VMAX", "erf": "VEXP",
}
_VIEW_PRIMS = {
    "broadcast_in_dim", "reshape", "transpose", "squeeze", "expand_dims",
    "convert_element_type", "copy", "stop_gradient", "slice", "rev",
    "dynamic_slice", "bitcast_convert_type", "iota",
}
_REDUCE_OP = {"reduce_sum": "VADD", "reduce_max": "VMAX", "reduce_min": "VMAX",
              "reduce_prod": "VMUL", "cumsum": "VADD", "cumlogsumexp": "VEXP"}

class _RegAlloc:
    """Simple rotating allocator: data registers R32..R199 (wrap-around
    introduces occasional false dependencies — as in real, register-pressured
    SASS), address pairs R4..R30, accumulators R200..R250."""

    def __init__(self):
        self._data = 32
        self._addr = 4
        self._acc = 200

    def data(self) -> str:
        r = self._data
        self._data += 1
        if self._data > 198:
            self._data = 32
        return f"R{r}"

    def addr_pair(self) -> str:
        r = self._addr
        self._addr += 2
        if self._addr > 30:
            self._addr = 4
        return f"R{r}"

    def acc(self) -> str:
        r = self._acc
        self._acc += 1
        if self._acc > 250:
            self._acc = 200
        return f"R{r}"


@dataclasses.dataclass
class LoweredKernel:
    spec: KernelSpec
    program: List[Instruction]           # dataflow order, empty control codes

    @property
    def name(self) -> str:
        return self.spec.name



# torch call (``torch.<name>``, ``Tensor.<name>`` or ``operator.<name>``)
# -> the jax primitive the reference's jnp tile function traces to; each
# entry is held against the reference in tests/test_torch_sched.py
_PRIM = {
    "matmul": "dot_general", "add": "add", "sub": "sub", "mul": "mul",
    "truediv": "div", "neg": "neg", "maximum": "max", "minimum": "min",
    "exp": "exp", "log": "log", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "sigmoid": "logistic", "tanh": "tanh", "abs": "abs",
    "lt": "lt", "gt": "gt", "ge": "ge", "eq": "eq",
    # jnp.where, jax.nn.silu and jnp.cumsum are calls named "jit" that
    # the reference does not walk into (module note): they lower through
    # the eltwise fallback
    "where": "jit", "silu": "jit", "cumsum": "jit",
    # basic indexing (``a[:, 0]``, ``seg[-1]``, ``seg[:, None]``) traces to
    # slice, dynamic_slice, squeeze and broadcast_in_dim: free views; an
    # index holding a tensor is a gather and raises (``_check_index``)
    "getitem": "slice",
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    # jnp.mean is reduce_sum, then div by the literal count (_Lowerer._walk)
    "mean": "mean",
    "reshape": "reshape", "t": "transpose", "T": "transpose",
    "float": "convert_element_type",
}


# torch calls whose arguments past the first few are the call's
# parameters (jax records them on the equation, not as operands)
_OPERANDS = {"cumsum": 1}


def _basic(item) -> bool:
    if isinstance(item, slice):
        return all(v is None or type(v) is int
                   for v in (item.start, item.stop, item.step))
    return item is None or item is Ellipsis or type(item) is int


def _check_index(node) -> None:
    """Indexing lowers for free only when the index is made of ints,
    slices, None and Ellipsis; the reference traces a tensor (or bool)
    index to ``gather``, which the lowering does not map."""
    index = node.args[1]
    items = index if isinstance(index, tuple) else (index,)
    if not all(_basic(i) for i in items):
        raise NotImplementedError(
            f"lowering: no TSASS mapping for the torch call 'getitem' with "
            f"the index {index!r} (a gather in the reference; ROADMAP A10)")


def _digest(text: str) -> int:
    """A stable stand-in for the reference's salted ``abs(hash(text))``."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "big")


def _literal_key(val) -> str:
    # jax types a Python scalar in an f32 expression as an f32 literal, so
    # the int 0 and the float 0.0 are one literal
    return f"literal {float(np.float32(val))!r}:f32"


class _Traced:
    """A tile function as a graph of torch calls in the order the source
    wrote them, with each value's shape (the port's ``make_jaxpr``)."""

    def __init__(self, fn, in_shapes: Sequence[Sequence[int]]):
        self.graph = torch.fx.symbolic_trace(fn).graph
        self.values: Dict[torch.fx.Node, object] = {}
        inputs = iter(in_shapes)
        for node in self.graph.nodes:
            if node.op == "placeholder":
                self.values[node] = torch.empty(tuple(next(inputs)),
                                                device="meta")
            elif node.op in ("call_function", "call_method"):
                if self.call_name(node) == "getitem":
                    _check_index(node)
                args = torch.fx.node.map_arg(node.args, self.values.get)
                kwargs = torch.fx.node.map_arg(node.kwargs, self.values.get)
                if node.op == "call_function":
                    self.values[node] = node.target(*args, **kwargs)
                else:
                    self.values[node] = getattr(args[0], node.target)(
                        *args[1:], **kwargs)
            elif node.op == "output":
                outs = node.args[0]
                self.outputs = (list(outs) if isinstance(outs, (tuple, list))
                                else [outs])
            else:
                raise NotImplementedError(
                    f"lowering: cannot trace {node.op} {node.target} (tile "
                    f"functions take their tiles as arguments)")

    def shape(self, node) -> tuple:
        return tuple(self.values[node].shape)

    @staticmethod
    def call_name(node) -> str:
        if node.target is getattr:           # an attribute: ``k.T``
            return node.args[1]
        if node.op == "call_method":
            return node.target
        return getattr(node.target, "__name__", str(node.target))

    @classmethod
    def prim(cls, node) -> str:
        name = cls.call_name(node)
        try:
            return _PRIM[name]
        except KeyError:
            raise NotImplementedError(
                f"lowering: no TSASS mapping for the torch call {name!r} "
                f"(add it to _PRIM as the jax primitive its jnp "
                f"counterpart traces to)") from None


class _Lowerer:
    def __init__(self, spec: KernelSpec):
        self.spec = spec
        self.ra = _RegAlloc()
        self.prog: List[Instruction] = []
        self.group_id = 0
        self.lit_regs: Dict[str, str] = {}
        self.vmem_off = 0

    # -- emission helpers ----------------------------------------------------

    def emit(self, opcode, operands, pred=None, tile=None, group=None,
             comment="") -> Instruction:
        ins = Instruction(opcode, list(operands), Control(), pred, tile,
                          group, comment)
        analyze_operands(ins)
        self.prog.append(ins)
        return ins

    def _vmem_slot(self, nbytes: int) -> int:
        off = self.vmem_off
        self.vmem_off += nbytes
        return off

    # -- DMA ------------------------------------------------------------------

    def dma_in(self, tile: TileIO, step: int, addr_reg: str) -> tuple:
        """Grouped CPYIN of one tile; returns the VMEM tile token.

        VMEM destinations address through the uniform base ``UR2`` +
        immediate (uniform registers are prologue constants, excluded from
        the stall-dependency scan like SASS descriptor URs)."""
        space = f"in_{tile.name}" if not tile.invariant else f"w_{tile.name}"
        token = (space, step if not tile.invariant else 0)
        base = self._vmem_slot(tile.nbytes)
        self.group_id += 1
        g = self.group_id
        nchunks = max(1, math.ceil(tile.nbytes / DMA_CHUNK))
        for cidx in range(nchunks):
            nbytes = min(DMA_CHUNK, tile.nbytes - cidx * DMA_CHUNK)
            self.emit(f"CPYIN.{nbytes}",
                      [f"[UR2+{hex(base + cidx * DMA_CHUNK)}]",
                       f"desc[UR16][{addr_reg}.64]"],
                      tile=token, group=g)
        return token

    def dma_out(self, tile: TileIO, step: int, token: tuple,
                src_reg: str, addr_reg: str) -> None:
        # stage VREG -> VMEM, then grouped CPYOUT
        nstv = max(1, math.ceil(tile.nbytes / LDV_CHUNK))
        base = self._vmem_slot(tile.nbytes)
        for cidx in range(nstv):
            self.emit("STV", [f"[UR2+{hex(base + cidx * LDV_CHUNK)}]", src_reg],
                      tile=token)
        self.group_id += 1
        g = self.group_id
        nchunks = max(1, math.ceil(tile.nbytes / DMA_CHUNK))
        for cidx in range(nchunks):
            nbytes = min(DMA_CHUNK, tile.nbytes - cidx * DMA_CHUNK)
            self.emit(f"CPYOUT.{nbytes}",
                      [f"desc[UR16][{addr_reg}.64+{hex(cidx * DMA_CHUNK)}]",
                       src_reg],
                      tile=token, group=g)

    def stage_in(self, tile: TileIO, token: tuple) -> List[str]:
        """LDV the tile into vector registers; returns the rep registers.
        Also emits the predicated-off boundary-check slots observed in real
        SASS (Fig. 13)."""
        self.emit("LDV", ["RZ", "[RZ]"], pred="@!PT")
        nldv = max(1, math.ceil(tile.nbytes / LDV_CHUNK))
        regs = []
        for cidx in range(min(nldv, 4)):
            r = self.ra.data()
            self.emit("LDV", [r, f"[UR2+{hex(self._ldv_src(token, cidx))}]"],
                      tile=token)
            regs.append(r)
        return regs

    def _ldv_src(self, token, cidx) -> int:
        # address text only needs to be stable per (tile, chunk)
        return (_digest(repr(token)) % 0x4000) + cidx * LDV_CHUNK

    # -- compute: graph walk ---------------------------------------------------

    def _literal_reg(self, key: str) -> str:
        if key not in self.lit_regs:
            r = self.ra.data()
            self.emit("SMOV", [r, key if len(key) < 12
                               else hex(_digest(key) % 2**24)])
            self.lit_regs[key] = r
        return self.lit_regs[key]

    def trace_compute(self, fn, in_shapes: Sequence[Sequence[int]],
                      in_reps: Sequence[List[str]]) -> List[str]:
        traced = _Traced(fn, in_shapes)
        env: Dict = {}
        placeholders = [n for n in traced.graph.nodes
                        if n.op == "placeholder"]
        for node, reps in zip(placeholders, in_reps):
            env[node] = list(reps)
        self._walk(traced, env)
        return [self._read(env, out)[0] for out in traced.outputs]

    def _read(self, env, arg) -> List[str]:
        if isinstance(arg, torch.fx.Node):
            return env[arg]
        return [self._literal_reg(_literal_key(arg))]

    def _walk(self, traced: _Traced, env) -> None:
        for node in traced.graph.nodes:
            if node.op not in ("call_function", "call_method"):
                continue
            prim = traced.prim(node)
            if prim == "dot_general":
                env[node] = self._emit_dot(traced, node, env)
            elif prim in _VIEW_PRIMS:
                src = node.args[0] if node.args else None
                if isinstance(src, torch.fx.Node) and src in env:
                    env[node] = env[src]
                else:
                    env[node] = [self._literal_reg(repr(prim))]
            elif prim in _REDUCE_OP:
                env[node] = self._emit_reduce(traced, node, env,
                                              _REDUCE_OP[prim])
            elif prim == "mean":
                # jax traces jnp.mean as reduce_sum, broadcast_in_dim (a
                # view), then div by the count as an f32 literal
                total = self._emit_reduce(traced, node, env,
                                          _REDUCE_OP["reduce_sum"])[0]
                count = (int(np.prod(traced.shape(node.args[0])))
                         // max(1, int(np.prod(traced.shape(node)))))
                env[node] = self._emit_vpu(
                    traced.shape(node),
                    [total, self._read(env, float(count))[0]],
                    _ELTWISE_OP["div"])
            else:   # elementwise / fallback
                env[node] = self._emit_eltwise(
                    traced, node, env, _ELTWISE_OP.get(prim, "VADD"))

    def _emit_dot(self, traced: _Traced, node, env) -> List[str]:
        a_shape, b_shape = traced.shape(node.args[0]), traced.shape(node.args[1])
        k = a_shape[-1]
        if len(a_shape) >= 3 and len(b_shape) >= 3:     # batched product
            batch = int(np.prod(a_shape[:-2])) or 1
            m = a_shape[-2]
        else:
            batch = 1
            m = int(np.prod(a_shape[:-1])) or 1
        n = int(np.prod(b_shape[-1:] if len(b_shape) >= 2 else ())) or 1
        nm = max(1, math.ceil(m / MXU_DIM))
        nn = max(1, math.ceil(n / MXU_DIM))
        nk = max(1, math.ceil(k / MXU_DIM))
        a_reps = self._read(env, node.args[0])
        b_reps = self._read(env, node.args[1])
        accs = [self.ra.acc() for _ in range(min(nm * nn, 8))]
        for b_i in range(batch):
            for im in range(nm):
                for ik in range(nk):
                    a_r = a_reps[(im * nk + ik) % len(a_reps)]
                    for i_n in range(nn):
                        acc = accs[(im * nn + i_n) % len(accs)]
                        b_r = b_reps[(ik * nn + i_n) % len(b_reps)]
                        # ptxas-style .reuse on the stationary operand of a
                        # burst (same `a` tile across the n sweep)
                        a_op = f"{a_r}.reuse" if i_n > 0 else a_r
                        self.emit("MXM", [acc, a_op, b_r])
        return [accs[0]]

    def _emit_eltwise(self, traced: _Traced, node, env, opcode) -> List[str]:
        args = node.args[:_OPERANDS.get(traced.call_name(node),
                                        len(node.args))]
        operands = [a for a in args
                    if isinstance(a, (torch.fx.Node, bool, int, float))]
        srcs = [self._read(env, a)[0] for a in operands[:3]]
        return self._emit_vpu(traced.shape(node), srcs, opcode)

    def _emit_vpu(self, out_shape, srcs: List[str], opcode) -> List[str]:
        out_elems = int(np.prod(out_shape)) or 1
        n = max(1, math.ceil(out_elems / VPU_ELEMS))
        dsts = []
        for i in range(min(n, 16)):
            d = self.ra.data()
            ops = [d] + [srcs[j % len(srcs)] for j in range(min(len(srcs), 2))]
            self.emit(opcode, ops)
            dsts.append(d)
        return [dsts[0]]

    def _emit_reduce(self, traced: _Traced, node, env, opcode) -> List[str]:
        in_elems = int(np.prod(traced.shape(node.args[0]))) or 1
        n = max(1, math.ceil(in_elems / VPU_ELEMS))
        src = self._read(env, node.args[0])[0]
        acc = self.ra.data()
        self.emit(opcode, [acc, src, src])
        for _ in range(min(n - 1, 15)):
            self.emit(opcode, [acc, acc, src])
        return [acc]


def lower(spec: KernelSpec) -> LoweredKernel:
    """Materialize the steady-state TSASS listing for one kernel config."""
    lo = _Lowerer(spec)

    # ---- prologue (basic block 0) -------------------------------------------
    lo.emit("SMOV", ["UR16", "0x0"])        # DMA descriptor
    lo.emit("SMOV", ["UR2", "0x0"])         # VMEM base (uniform)
    addr_regs: Dict[str, str] = {}
    for t in spec.inputs + spec.outputs:
        r = lo.ra.addr_pair()
        lo.emit("SMULW", [f"{r}.64", "R0", hex(t.nbytes)])
        addr_regs[t.name] = r

    # invariant tiles (weights/scales): loaded once, addresses never
    # redefined inside the loop body -> their loop uses hit the denylist
    invariant_tokens: Dict[str, tuple] = {}
    for t in spec.inputs:
        if t.invariant:
            invariant_tokens[t.name] = lo.dma_in(t, 0, addr_regs[t.name])

    lo.emit("LABEL", ["L0"])

    # ---- unrolled steady-state loop (one big basic block) --------------------
    in_shapes = [t.shape for t in spec.inputs]
    out_reps_last: List[str] = []
    for step in range(spec.steps):
        reps: List[List[str]] = []
        for t in spec.inputs:
            if t.invariant:
                token = invariant_tokens[t.name]
            else:
                # step 0 addresses straight from the prologue-computed
                # parameters (its DMA lands on the denylist: defs cross the
                # label, §3.2); later steps bump in-block — the fixed-latency
                # producer feeding the DMA that Algorithm 1 guards
                if step > 0:
                    r = addr_regs[t.name]
                    hi = f"R{int(r[1:]) + 1}"
                    lo.emit("SADD", [r, r, hex(t.nbytes)])
                    lo.emit("SADDX", [hi, hi, "RZ"])  # carry into the pair's
                    # odd half (the paper's IADD3.X pattern, §3.2)
                token = lo.dma_in(t, step, addr_regs[t.name])
            reps.append(lo.stage_in(t, token))
        out_reps_last = lo.trace_compute(spec.tile_fn, in_shapes, reps)

        store_now = (not spec.accumulate) or step == spec.steps - 1
        if store_now:
            outs = out_reps_last
            if spec.accumulate and spec.epilogue_fn is not None:
                accs = spec.tile_fn(*(torch.empty(s, device="meta")
                                      for s in in_shapes))
                if not isinstance(accs, (tuple, list)):
                    accs = (accs,)
                outs = lo.trace_compute(spec.epilogue_fn,
                                        [a.shape for a in accs],
                                        [[r] for r in out_reps_last])
            for oi, t in enumerate(spec.outputs):
                if step > 0:
                    r = addr_regs[t.name]
                    hi = f"R{int(r[1:]) + 1}"
                    lo.emit("SADD", [r, r, hex(t.nbytes)])
                    lo.emit("SADDX", [hi, hi, "RZ"])
                token = (f"out_{t.name}", step)
                lo.dma_out(t, step, token, outs[min(oi, len(outs) - 1)],
                           addr_regs[t.name])

    lo.emit("EXIT", [])
    return LoweredKernel(spec=spec, program=lo.prog)


# ---------------------------------------------------------------------------
# serve-time dispatch shim
# ---------------------------------------------------------------------------

def resolve_schedule(cache, kernel: str, scenario=None, target=None,
                     on_missing="baseline"):
    """Deploy-time counterpart of :func:`lower`: instead of *building* a
    schedule, resolve the one already tuned for this workload point.

    The request's scenario (shape/dtype/occupancy of the traffic actually
    hitting the engine) dispatches to the **nearest tuned bucket** of the
    kernel's cache index — a pure index lookup, zero autotune and zero
    machine execution, falling back through the default bucket so
    pre-scenario caches keep serving.

    ``on_missing`` is the degradation policy:

    * ``"baseline"`` (default) — a kernel with no usable cached schedule
      degrades gracefully: ``None`` is returned (the engine serves the
      -O3 baseline this module's listing feeds to
      :mod:`repro_torch.sched.baseline`) and the cache's ``fallbacks`` counter
      ticks.  A *corrupt* cached schedule
      (:class:`~repro_torch.sched.cache.CacheVersionError`) is quarantined
      (``*.quarantine``, via :meth:`ScheduleCache.quarantine_kernel`)
      with a warning, the lookup retried once over the cleaned
      directory, and only then falls back to the baseline.
    * ``"raise"`` — strict mode for production rollouts that must not
      silently serve unoptimized kernels: a missing schedule raises
      :class:`FileNotFoundError` and a corrupt one propagates its
      :class:`CacheVersionError` untouched (no quarantine).

    ``cache`` is a :class:`repro_torch.sched.cache.ScheduleCache`; ``scenario``
    a :class:`repro_torch.sched.scenario.Scenario`, a bucket string, or ``None``
    for the legacy single-point lookup.
    """
    if on_missing not in ("baseline", "raise"):
        raise ValueError(
            f"on_missing must be 'baseline' or 'raise', got {on_missing!r}")

    def _lookup():
        if scenario is None:
            return cache.lookup_best(kernel, target=target)
        return cache.dispatch(kernel, scenario, target=target)

    if on_missing == "raise":
        art = _lookup()
        if art is None:
            raise FileNotFoundError(
                f"no cached schedule for {kernel} and on_missing='raise'; "
                f"run optimize() offline first or serve with "
                f"on_missing='baseline'")
        return art

    from repro_torch.sched.cache import CacheVersionError
    try:
        art = _lookup()
    except CacheVersionError as e:
        quarantine = getattr(cache, "quarantine_kernel", None)
        renamed = quarantine(kernel, target) if quarantine else []
        warnings.warn(
            f"corrupt cached schedule for {kernel} ({e}); quarantined "
            f"{len(renamed)} file(s), serving the -O3 baseline unless a "
            f"clean entry remains")
        try:
            art = _lookup()          # retry once over the cleaned directory
        except CacheVersionError:
            art = None
    if art is None and hasattr(cache, "fallbacks"):
        cache.fallbacks += 1
    return art


def schedule_plan(kernel_names, cache_dir=None, target=None, cache=None,
                  scenario=None, on_missing="baseline"):
    """Deploy-time schedule lookup for a serve engine's kernel fleet —
    the fleet-shaped wrapper over :func:`resolve_schedule` (and what
    ``repro_torch.serve.engine.schedule_plan`` re-exports).

    ``kernel_names`` takes bare registry names (legacy: keys are the
    names, resolved at ``scenario`` — the engine's current traffic point,
    or the default bucket when ``None``) and/or the ``(kernel, scenario)``
    pairs :func:`repro_torch.launch.specs.kernel_fleet` yields (keys are
    ``(name, bucket)``, one resolution per workload the model serves).

    Every resolution is a nearest-tuned-bucket pure index lookup — **no**
    autotune and no machine execution at serve time (the paper's §4.2
    search/deploy split).  ``None`` marks a kernel that serves the -O3
    baseline.  ``on_missing`` is :func:`resolve_schedule`'s degradation
    policy: ``"baseline"`` (default) degrades missing/corrupt entries to
    the baseline with a warning + quarantine; ``"raise"`` keeps the loud
    behaviour a production rollout may prefer (missing entries raise
    :class:`FileNotFoundError`, corrupt caches their
    :class:`CacheVersionError`).
    """
    from repro_torch.sched.cache import DEFAULT_CACHE_DIR, TARGET, ScheduleCache
    if cache is None:
        cache = ScheduleCache(cache_dir or DEFAULT_CACHE_DIR,
                              target or TARGET)
    plan = {}
    for item in kernel_names:
        if isinstance(item, str):
            plan[item] = resolve_schedule(cache, item, scenario,
                                          on_missing=on_missing)
        else:
            name, scen = item
            key = (name, scen.bucket if scen is not None else "default")
            plan[key] = resolve_schedule(cache, name, scen,
                                         on_missing=on_missing)
    return plan
