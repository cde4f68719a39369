"""Logical-axis sharding rules: the single place that maps *logical* axis
names (on :class:`repro_torch.nn.core.ParamSpec` leaves) and runtime
tensors onto *mesh* axes.

Port of ``repro/dist/sharding.py``.  Mesh axes (see
:mod:`repro_torch.launch.mesh`):

  ``pod``    — outermost data-parallel replica groups (multi-pod runs);
  ``data``   — within-pod data parallelism (batch, FSDP weight shards);
  ``model``  — tensor / expert parallelism;
  ``pipe``   — pipeline stages (:mod:`repro_torch.dist.pipeline`).

Every rule degrades by *divisibility fallback*: a dimension that is not
divisible by its target mesh axis (or whose target axis is absent) is
replicated instead.

The rules return :class:`P`, the port's PartitionSpec: a tuple of
entries, each a mesh-axis name, a tuple of names or ``None``, equal
entry for entry to the reference's ``PartitionSpec`` on the same mesh
shape.  Where the reference returns ``NamedSharding``s
(:func:`param_shardings`, :func:`decode_cache_shardings`,
:func:`kv_pool_shardings`) the port returns the spec tree; a rank
places tensors by it with :func:`shard_tree` (this rank's block of a
global tree) and :func:`gather_tree` (the global tree back from every
rank's blocks), and :class:`NamedSharding` binds one spec to a mesh
(:func:`named_shardings`: what ``ckpt.checkpoint.restore(shardings=)``
takes).  Inside the GSPMD step, :func:`gather_for_use` assembles a
parameter from its blocks differentiably, and :func:`replicated_axes` /
:func:`sharded_axes` say over which axes its gradient is summed and its
squared norm counted.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.dist.collectives import all_gather
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# logical axis -> mesh axes to try, in preference order.  ``embed`` (the
# contraction dim of every matmul) shards over ``data`` — classic FSDP.
# ``mlp``/``heads``/``vocab``/``experts`` shard over ``model``
# (tensor/expert parallelism).  ``layers`` is the scan dimension and stays
# replicated.
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
}


def _normalize(entry):
    """An entry as ``PartitionSpec`` keeps it: a sequence of one axis is
    that axis, an empty one ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


class P:
    """The port's PartitionSpec: one entry per dimension (a mesh-axis
    name, a tuple of names sharded major to minor, or ``None``).  A leaf
    of the port's trees (not a tuple, so tree utilities keep it whole);
    ``tuple(spec)`` gives the entries.  ParamSpecs are leaves too, so
    the rules map spec trees with ``tree_map``."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_normalize(p) for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 \
            else f"P({self._parts[0]!r})"


# ---------------------------------------------------------------------------
# mesh introspection (Mesh and AbstractMesh alike)
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} for a mesh or an abstract mesh."""
    return dict(mesh.shape)


def dp_axes(mesh):
    """The data-parallel mesh axes present on ``mesh``: ``("pod", "data")``,
    ``"data"``, or None.  Usable directly inside a :class:`P`."""
    present = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def pipe_size(mesh) -> int:
    return axis_sizes(mesh).get("pipe", 1)


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def spec_for_axes(axes: Sequence[Optional[str]], mesh,
                  shape: Optional[Sequence[int]] = None) -> P:
    """Map a tuple of logical axis names to a :class:`P` on ``mesh``.

    A dimension is sharded over the first mesh axis in its rule that (a)
    exists on the mesh, (b) is not already used by an earlier dimension,
    and (c) divides the dimension size (when ``shape`` is given);
    otherwise it is replicated.
    """
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for i, name in enumerate(axes):
        choice = None
        for mesh_ax in LOGICAL_RULES.get(name, ()):
            n = sizes.get(mesh_ax)
            if n is None or mesh_ax in used:
                continue
            if shape is not None and shape[i] % n != 0:
                continue
            choice = mesh_ax
            used.add(mesh_ax)
            break
        out.append(choice)
    return P(*out)


def _is_param_spec(x) -> bool:
    # duck-typed so this module never imports repro_torch.nn
    return hasattr(x, "axes") and hasattr(x, "shape")


def logical_specs(spec_tree, mesh):
    """ParamSpec tree -> :class:`P` tree (same structure as the params
    ``init_params`` builds from the same spec tree)."""
    return tree_map(lambda s: spec_for_axes(s.axes, mesh, s.shape),
                     spec_tree)


def param_shardings(spec_tree, mesh):
    """The reference returns a ``NamedSharding`` tree here; the port
    returns the :class:`P` tree (:func:`logical_specs`), by which the
    GSPMD step (``train.step.make_train_step(mesh=...)``) places each
    parameter and its AdamW moments (:func:`named_shardings` binds it
    to the mesh)."""
    return logical_specs(spec_tree, mesh)


# ---------------------------------------------------------------------------
# pipeline-step specs (train.step.make_sharded_train_step)
# ---------------------------------------------------------------------------

# top-level parameter-tree keys whose leaves are stacked per-layer weights
# (leading dim = n_layers) that the pipeline step splits one block of
# contiguous layers per ``pipe`` rank.  Everything else is "glue" (embed,
# final norm, lm head) and stays replicated across the pipe axis.
STAGE_KEYS: Tuple[str, ...] = ("layers",)

# logical axes the explicit-TP pipeline step shards over ``model``: the
# attention head / MLP column dims whose partial projections the stage body
# reassembles with an in-stage psum (``repro_torch.nn`` ``tp_axis``
# paths).  No divisibility fallback here — ``make_sharded_train_step``
# validates the dims eagerly, because a silently replicated leaf would make
# the stage's unconditional psum double-count.
TP_STAGE_AXES: Tuple[str, ...] = ("mlp", "heads", "kv_heads")


def _stage_leaf_spec(leaf, tp: bool) -> P:
    if not tp:
        return P("pipe")
    if not _is_param_spec(leaf):
        raise TypeError(
            "sharded_param_specs needs a ParamSpec tree (logical axes) to "
            "compose pipe with tensor parallelism; got a bare array leaf")
    parts = ["pipe" if i == 0 and ax == "layers"
             else ("model" if ax in TP_STAGE_AXES else None)
             for i, ax in enumerate(leaf.axes)]
    return P(*parts)


def sharded_param_specs(params_tree, stage_keys: Sequence[str] = STAGE_KEYS,
                        mesh=None):
    """:class:`P` tree for the pipeline step's parameters: stacked
    per-layer leaves shard their leading (layer) dim over ``pipe``; glue
    parameters are replicated across ``pipe`` (and ``model``).  When
    ``mesh`` carries a ``model`` axis of size > 1, stage leaves additionally
    shard their :data:`TP_STAGE_AXES` dims over ``model``.  Accepts a
    params tree or a ParamSpec tree (the latter is required for TP, which
    needs the logical axes)."""
    tp = mesh is not None and model_size(mesh) > 1

    def sub(key, tree):
        if key in stage_keys:
            return tree_map(lambda s: _stage_leaf_spec(s, tp), tree)
        return tree_map(lambda _: P(), tree)
    return {k: sub(k, v) for k, v in params_tree.items()}


def sharded_ef_specs(params_tree, stage_keys: Sequence[str] = STAGE_KEYS,
                     mesh=None):
    """:class:`P` tree for the compressed-psum error-feedback residuals:
    each leaf is its parameter's spec (:func:`sharded_param_specs`) with a
    leading ``pod``-block dim prepended — the residual is local to a pod
    rank, and mirrors the parameter/gradient sharding underneath."""
    p_specs = sharded_param_specs(params_tree, stage_keys, mesh)
    return tree_map(lambda sp: P("pod", *sp), p_specs)


# ---------------------------------------------------------------------------
# activation / batch shardings
# ---------------------------------------------------------------------------

def batch_spec(mesh, batch: int, ndim: int = 2) -> P:
    """Leading-dim data parallelism with divisibility fallback."""
    dp = dp_axes(mesh)
    if dp is None or batch % dp_size(mesh) != 0:
        dp = None
    return P(dp, *([None] * (ndim - 1)))


def cache_sharding(mesh, batch: int, seq: int, n_kv_heads: int) -> P:
    """:class:`P` for a (batch, seq, kv_heads, head_dim) KV cache.

    Heuristics, in order:
      * batch not data-divisible (the batch=1 long-context cell): shard the
        *sequence* over every divisible mesh axis;
      * kv heads divisible by ``model``: head sharding (dense GQA/MHA);
      * MQA / few-kv-head models: sequence sharding over ``model``;
      * otherwise replicate the non-batch dims.
    """
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    b_ax = dp_axes(mesh)
    if b_ax is not None and batch % dp_size(mesh) == 0:
        if n_kv_heads % model == 0 and model > 1:
            return P(b_ax, None, "model", None)
        if model > 1 and seq % model == 0:
            return P(b_ax, "model", None, None)
        return P(b_ax, None, None, None)

    # batch not shardable: spread the sequence as widely as divisibility
    # allows (prefer the full data×model slice, fall back to model only)
    for axes in (tuple(a for a in ("pod", "data", "model") if a in sizes),
                 tuple(a for a in ("data", "model") if a in sizes),
                 ("model",) if "model" in sizes else ()):
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if n > 1 and seq % n == 0:
            return P(None, axes, None, None)
    return P(None, None, None, None)


def decode_cache_leaf_spec(cfg, shape, mesh) -> P:
    """The rule :func:`decode_cache_shardings` applies to one cache leaf of
    ``shape``."""
    dp = dp_axes(mesh)
    b_ax = dp if shape[0] % dp_size(mesh) == 0 else None
    if len(shape) == 4 and shape[2] == cfg.n_kv_heads \
            and shape[3] == cfg.head_dim:
        return cache_sharding(mesh, shape[0], shape[1], cfg.n_kv_heads)
    if len(shape) == 4:  # ssm state (B, H, P, N)
        h_ax = "model" if shape[1] % model_size(mesh) == 0 else None
        return P(b_ax, h_ax, None, None)
    if len(shape) == 3:  # mla latent (B, S, R) / ssm conv (B, W, C)
        # shard the sequence, NOT the latent dim: the attention contracts
        # over R, and a contraction-dim sharding would gather the whole
        # cache every layer
        if shape[1] % model_size(mesh) == 0 \
                and shape[1] >= model_size(mesh):
            return P(b_ax, "model", None)
        if cfg.mla and shape[2] in (cfg.kv_lora_rank, cfg.qk_rope_dim):
            return P(b_ax, None, None)   # latent IS the contraction dim
        last_ax = "model" if shape[2] % model_size(mesh) == 0 \
            and shape[2] >= model_size(mesh) else None
        return P(b_ax, None, last_ax)
    return P(*([None] * len(shape)))


def decode_cache_shardings(cfg, caches, mesh):
    """:class:`P` tree for a decode-cache tree (any model family); leaves
    (tensors or anything with a ``shape``) are classified by rank and
    shape the way ``serve.decode.init_caches`` builds them.  The
    reference returns ``NamedSharding``s; the port's ``generate(mesh=)``
    places each rank's cache blocks by these (:func:`shard_zeros`) and
    ``decode_step(mesh=, specs=)`` reads them."""
    return tree_map(lambda x: decode_cache_leaf_spec(cfg, tuple(x.shape),
                                                      mesh), caches)


def paged_leaf_spec(cfg, shape, mesh) -> P:
    """The rule :func:`kv_pool_shardings` applies to one paged leaf:
    block-major pages ``(num_blocks, block_size, ...)`` shard KV heads over
    the model axis and never the block or in-block position dims."""
    if len(shape) == 4 and shape[2] == cfg.n_kv_heads \
            and shape[3] == cfg.head_dim:
        h_ax = "model" if cfg.n_kv_heads % model_size(mesh) == 0 else None
        return P(None, None, h_ax, None)
    return P(*([None] * len(shape)))


def kv_pool_shardings(cfg, caches, mesh, kinds=None):
    """Specs for the serve engine's KV cache, dense (``kinds=None``: the
    decode-cache rules) or paged (``kinds`` =
    ``serve.decode.paged_cache_kinds(cfg)``: ``"slot"`` entries keep the
    decode-cache rules, paged ones :func:`paged_leaf_spec`).  The
    reference returns ``NamedSharding``s; ``ServeEngine(mesh=)`` makes
    each rank's blocks of its pool by these."""
    if kinds is None:
        return decode_cache_shardings(cfg, caches, mesh)
    return [decode_cache_shardings(cfg, c, mesh) if kind == "slot"
            else tree_map(lambda x: paged_leaf_spec(cfg, tuple(x.shape),
                                                     mesh), c)
            for c, kind in zip(caches, kinds)]


# ---------------------------------------------------------------------------
# placing a global tree on the ranks, and back
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_index(mesh, entry) -> Tuple[int, int]:
    """(this rank's block index, block count) of a dimension sharded by
    ``entry`` — several axes combine major to minor."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def shard_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        idx, n = block_index(mesh, entry)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways ({spec})")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def shard_zeros(tree, specs, mesh, device):
    """This rank's blocks, zero-filled on ``device``, of a global tree
    known by its leaves' shapes and types (on the meta device, say: no
    rank allocates the global tree)."""
    return tree_map(lambda x, s: torch.zeros(
        shard_leaf(x, s, mesh).shape, dtype=x.dtype, device=device),
        tree, specs)


def live_axes(mesh, entry):
    """The bound axes (of size > 1) that a spec ``entry`` shards over,
    major to minor."""
    return tuple(mesh.axis(a) for a in entry_axes(entry)
                 if mesh.shape[a] > 1)


def global_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The global shape of a block of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] *= block_index(mesh, entry)[1]
    return tuple(out)


def shard_tree(tree, specs, mesh):
    """This rank's blocks of a global tree (each a contiguous copy, so the
    global tree can be freed)."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh).contiguous(),
                    tree, specs)


def gather_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` under ``spec`` (a
    collective: every rank calls it, and every rank gets the result)."""
    for dim in reversed(range(len(spec))):
        for a in reversed(entry_axes(spec[dim])):
            if mesh.shape[a] == 1:
                continue
            x = all_gather(x, mesh.axis(a), dim, tiled=True)
    return x


def gather_for_use(x: torch.Tensor, spec: P, mesh,
                   keep: Sequence[str] = ()) -> torch.Tensor:
    """``x``, this rank's block under ``spec``, all-gathered over every
    axis of ``spec`` except those in ``keep`` (differentiable: the
    gradient comes back summed over those axes and scattered to the
    block, FSDP's reduce-scatter)."""
    for dim in reversed(range(len(spec))):
        for a in reversed(entry_axes(spec[dim])):
            if a in keep or mesh.shape[a] == 1:
                continue
            x = all_gather(x, mesh.axis(a), dim, tiled=True)
    return x


def sharded_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` (of size > 1) that ``spec`` shards a dimension
    over, in mesh order."""
    used = {a for entry in spec for a in entry_axes(entry)}
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.shape[a] > 1)


def replicated_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` (of size > 1) over which a tensor placed by
    ``spec`` is replicated: every rank along them holds the same block."""
    used = set(sharded_axes(spec, mesh))
    return tuple(a for a in mesh.axis_names
                 if a not in used and mesh.shape[a] > 1)


class NamedSharding:
    """A :class:`P` bound to a mesh, the reference's
    ``jax.sharding.NamedSharding``: :meth:`shard` gives this rank's block
    of a global tensor on the mesh's device, :meth:`gather` the global
    tensor back (a collective)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard_leaf(x, self.spec, self.mesh).contiguous().to(
            self.mesh.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_leaf(x, self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named_shardings(specs, mesh):
    """A :class:`NamedSharding` tree from a :class:`P` tree."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def gather_tree(local, specs, mesh):
    """The global tree from every rank's blocks (a collective, leaf by
    leaf in tree order)."""
    return tree_unflatten(local, [gather_leaf(x, s, mesh) for x, s in
                                  zip(tree_leaves(local), tree_leaves(specs))])
