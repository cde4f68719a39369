"""Train-step construction: loss, gradients, microbatching, the
optimizer update.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``, the
reference's step.  Gradients come from autograd over the port's
forward, where the kernels' ``autograd.Function``s stand in for XLA's
autodiff of the reference's jnp code.  The encoder-decoder's loss runs
:func:`repro_torch.models.encdec.forward` over the batch's ``frames``.

With a mesh, ``make_train_step(mesh=...)`` is the reference's GSPMD
step, run by every rank of a :class:`repro_torch.launch.mesh.Mesh` with
the partition written out: each rank holds the parameters' and AdamW
moments' blocks by ``param_shardings`` (:func:`sharded_state_specs`),
takes its block of each microbatch by ``batch_spec``, and runs the
forward with ``mesh`` (:func:`repro_torch.models.lm.forward`: FSDP
gathers, tensor and expert parallelism over ``model``, and the
embedding, head and loss on each rank's block of the vocabulary).  Every
collective's backward is its exact transpose, so autograd of the ranks'
program is the gradient of the global loss once each rank weighs its
loss so that the ranks' losses sum to it: the owner of a batch block is
its ``model`` rank 0, and a batch replicated for want of divisibility
is owned by its first data-parallel rank alone.  A gradient is then
summed over the axes its parameter is replicated on, the grad-norm
counts each block once, and clipping uses that global norm.

``make_sharded_train_step`` is the reference's explicit-collective step
(its ``jax.shard_map`` body), run by every rank of a
:class:`repro_torch.launch.mesh.Mesh`, one process each: the decoder
blocks stream through a pipeline schedule over ``pipe``, tensor
parallelism over ``model`` psums the partial projections in-stage, and
the gradients are reduced over ``pipe``/``model`` by the plan the
parameter specs give, averaged over ``data``, and over ``pod`` either
compressed (bf16 + error feedback, ``TrainState.ef``) or in f32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist import compress
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import get_schedule
from repro_torch.kernels.ref import wide
from repro_torch.models import encdec, lm
from repro_torch.optim.adamw import AdamState, Optimizer, apply_updates
from repro_torch.utils import spans
from repro_torch.utils.tree import (global_norm, sum_squares, tree_leaves,
                                    tree_map, tree_unflatten)


class TrainState(NamedTuple):
    params: Dict
    opt_state: object
    step: torch.Tensor
    # error-feedback residuals for the compressed pod-axis gradient
    # reduction (None outside the multi-pod pipeline step).  Leaves carry a
    # leading pod-block dim: global (pod, *param_shape), P("pod", ...) —
    # each rank holds its own (1, ...) block.
    ef: object = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab=None) -> torch.Tensor:
    """Mean token NLL in f32.  logits (B, S, V); labels (B, S) ints.

    With ``vocab`` (a bound axis) ``logits`` is this rank's block of the
    vocabulary's columns, the blocks in coordinate order, and the NLL is
    vocabulary-parallel: log(sum of exp(logits - max)) + max minus the
    label's logit, the max over ``vocab`` from an all-gather of the row
    maxima (detached: the NLL does not depend on it), the sum psummed
    over ``vocab``, and the label's logit taken by the rank whose block
    holds it (masked, then psummed).  The psums' backward psums the
    cotangent, so however the ranks weigh their losses, each rank's
    block gets its softmax gradient."""
    with spans.span(spans.LOSS):
        if vocab is None:
            logp = torch.log_softmax(wide(logits), dim=-1)
            nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
            return nll.mean()
        z = wide(logits)
        n = z.shape[-1]
        with torch.no_grad():
            top = col.all_gather(z.amax(-1), vocab, 0).amax(0)
        z = z - top[..., None]
        total = col.psum(torch.exp(z).sum(-1), vocab)
        t = labels.long() - vocab.index * n
        picked = torch.gather(z, -1, t.clamp(0, n - 1)[..., None])[..., 0]
        hit = (t >= 0) & (t < n)
        label = col.psum(torch.where(hit, picked, torch.zeros_like(picked)),
                         vocab)
        return (torch.log(total) - label).mean()


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """The mean token NLL of ``batch`` and its metrics.  With ``mesh``
    (the GSPMD step) the forward leaves each rank its block of the
    vocabulary where ``lm.vocab_axis`` splits it, and the loss is
    :func:`cross_entropy`'s vocabulary-parallel form."""
    if cfg.family == "encdec":
        logits = encdec.forward(params, batch["frames"], batch["tokens"],
                                cfg, mesh=mesh, vocab_block=True)
    else:
        logits = lm.forward(params, batch["tokens"], cfg, mesh=mesh,
                            vocab_block=True)
    loss = cross_entropy(logits, batch["labels"], lm.vocab_axis(cfg, mesh))
    return loss, {"loss": loss}


def compute_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                  num_microbatches: int = 1) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of ``loss_fn`` at ``params``; grads share params'
    structure and dtypes.  ``num_microbatches > 1`` accumulates f32
    gradients over sequential slices of the batch and averages them, as
    the reference's scan does."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)

    def one(b):
        with torch.enable_grad():
            loss, _ = loss_fn(live, b, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if num_microbatches == 1:
        loss, grads = one(batch)
        return loss, tree_unflatten(params, grads)
    loss_sum = torch.zeros((), device=leaves[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    for i in range(num_microbatches):
        micro = {k: v.reshape((num_microbatches, v.shape[0]
                               // num_microbatches) + v.shape[1:])[i]
                 for k, v in batch.items()}
        loss, grads = one(micro)
        loss_sum = loss_sum + loss
        for a, g in zip(acc, grads):
            a.add_(g)
    scale = 1.0 / num_microbatches
    return loss_sum * scale, tree_unflatten(params, [a * scale for a in acc])


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics) with metrics
    ``loss``, ``grad_norm`` (before clipping) and ``step`` as 0-d tensors.
    The optimizer updates the moments of ``state`` in place (see
    :mod:`repro_torch.optim.adamw`): pass each state once.

    With ``mesh`` (every rank calls the step) it is the GSPMD step:
    ``state`` holds this rank's blocks (``shard_tree`` of the global
    state by :func:`sharded_state_specs`) and ``batch`` the global
    batch, whose microbatches (contiguous slices, as the reference's
    scan takes them) each rank cuts to its block.  The metrics are
    global, the same on every rank.  A ``pipe`` axis is ignored, as
    the reference's jit step ignores it: no rule shards over it, so its
    ranks are replicas, and its rank 0 owns the loss.  A mesh with
    ``pipe`` runs a pipeline with ``make_sharded_train_step``."""
    if mesh is not None:
        return _gspmd_train_step(cfg, opt, mesh, num_microbatches)

    def train_step(state: TrainState, batch: Dict):
        loss, grads = compute_grads(state.params, batch, cfg,
                                    num_microbatches)
        with spans.span(spans.OPTIM):
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            with torch.no_grad():
                params = apply_updates(state.params, updates)
            gnorm = global_norm(grads)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def _model_spec(cfg: ModelConfig):
    return (encdec if cfg.family == "encdec" else lm).model_spec(cfg)


def _global_norm(grads, norm_axes, mesh) -> torch.Tensor:
    """The global norm of gradient blocks: each leaf's squared sum psums
    over the axes it is sharded on, so a block replicated elsewhere
    counts once."""
    groups: Dict[tuple, list] = {}
    for g, axes in zip(grads, norm_axes):
        groups.setdefault(axes, []).append(sum_squares(g))
    total = None
    for axes, parts in groups.items():
        part = torch.sum(torch.stack(parts))
        if axes:
            part = col.psum(part, [mesh.axis(a) for a in axes])
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip(grads, gnorm, opt: Optimizer):
    """Clip against the global norm here: every per-rank norm
    ``opt.update`` sees is then <= ``max_grad_norm``, so its own clip is
    a no-op and clipping happens exactly once."""
    if opt.max_grad_norm is None:
        return grads
    scale = torch.clamp(opt.max_grad_norm / (gnorm + 1e-12), max=1.0)
    return [g.float() * scale for g in grads]


def _gspmd_train_step(cfg: ModelConfig, opt: Optimizer, mesh,
                      num_microbatches: int):
    specs = tree_leaves(shd.param_shardings(_model_spec(cfg), mesh))
    sum_axes = [[mesh.axis(a) for a in shd.replicated_axes(s, mesh)]
                for s in specs]
    norm_axes = [shd.sharded_axes(s, mesh) for s in specs]
    every = [mesh.axis(a) for a in mesh.axis_names if mesh.shape[a] > 1]
    dp = [a for a in ("pod", "data") if a in mesh.shape]

    def train_step(state: TrainState, batch: Dict):
        n = num_microbatches
        size = batch["tokens"].shape[0]
        if size % n:
            raise ValueError(f"global batch {size} not divisible by "
                             f"{n} microbatches")
        mb = size // n
        split = shd.batch_spec(mesh, mb)[0] is not None
        owns = mesh.coords.get("model", 0) == 0 and \
            mesh.coords.get("pipe", 0) == 0 and (
                split or all(mesh.coords[a] == 0 for a in dp))
        weight = (1.0 / shd.dp_size(mesh) if split else 1.0) if owns else 0.0
        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(state.params)]
        live = tree_unflatten(state.params, leaves)
        acc, loss_sum = None, None
        for i in range(n):
            micro = {k: shd.shard_leaf(v[i * mb:(i + 1) * mb],
                                       shd.batch_spec(mesh, mb, v.ndim),
                                       mesh) for k, v in batch.items()}
            with torch.enable_grad():
                part = loss_fn(live, micro, cfg, mesh=mesh)[0] * weight
            grads = torch.autograd.grad(part, leaves)
            if acc is None:
                acc = [wide(g) for g in grads]
                loss_sum = part.detach()
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
                loss_sum = loss_sum + part.detach()
        del live, leaves
        with torch.no_grad():
            grads = [col.psum(g, axes) if axes else g
                     for g, axes in zip(acc, sum_axes)]
            loss = col.psum(loss_sum, every) if every else loss_sum
            if n > 1:
                scale = 1.0 / n
                loss = loss * scale
                grads = [g * scale for g in grads]
        with spans.span(spans.OPTIM):
            with torch.no_grad():
                gnorm = _global_norm(grads, norm_axes, mesh)
                grads = tree_unflatten(state.params,
                                       _clip(grads, gnorm, opt))
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            with torch.no_grad():
                params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# the explicit-collective step: a pipeline over `pipe`, TP over `model`,
# compressed psum over `pod`
# ---------------------------------------------------------------------------

class PipelineStepError(ValueError):
    """A config/mesh combination the pipeline step cannot stage (raised
    eagerly by :func:`make_sharded_train_step`'s validation)."""


def wants_ef(cfg: ModelConfig, mesh) -> bool:
    """True when the sharded step on ``mesh`` will carry error-feedback
    state (compressed pod-axis reduction active)."""
    return (cfg.compress_pod_grads and shd.pipe_size(mesh) > 1
            and shd.axis_sizes(mesh).get("pod", 1) > 1)


def init_ef_state(params, mesh, spec_tree=None):
    """Zero error-feedback residuals for :func:`make_sharded_train_step`:
    this rank's f32 block of the global ``(pod, *param_shape)`` residuals
    (``shd.sharded_ef_specs``), made in place — a ``(1, *local_shape)``
    block beside each of this rank's parameter blocks ``params``.

    ``spec_tree`` (the model's ParamSpec tree) is required when ``mesh``
    carries a ``model`` axis > 1, as in the reference; the blocks take
    their shapes from ``params`` either way."""
    shd.sharded_ef_specs(spec_tree if spec_tree is not None else params,
                         mesh=mesh)   # the reference's checks
    return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def sharded_state_specs(cfg: ModelConfig, mesh,
                        ef: bool = False) -> TrainState:
    """The :class:`repro_torch.dist.sharding.P` tree of a distributed
    step's :class:`TrainState` (AdamW's state): the pipeline step's on a
    mesh with a ``pipe`` axis > 1 (``ef`` with residuals or None), else
    the GSPMD step's, by ``param_shardings``.  It is what ``shard_tree`` /
    ``gather_tree`` take to move a state between its global layout and
    the ranks' blocks."""
    if shd.pipe_size(mesh) < 2:
        p_specs = shd.param_shardings(_model_spec(cfg), mesh)
        return TrainState(params=p_specs,
                          opt_state=AdamState(step=shd.P(), mu=p_specs,
                                              nu=p_specs),
                          step=shd.P())
    p_specs = shd.sharded_param_specs(lm.model_spec(cfg), shd.STAGE_KEYS,
                                      mesh)
    ef_specs = (shd.sharded_ef_specs(lm.model_spec(cfg), shd.STAGE_KEYS,
                                     mesh) if ef else None)
    return TrainState(params=p_specs,
                      opt_state=AdamState(step=shd.P(), mu=p_specs,
                                          nu=p_specs),
                      step=shd.P(), ef=ef_specs)


def make_sharded_train_step(cfg: ModelConfig, opt: Optimizer, mesh, *,
                            num_microbatches: Optional[int] = None,
                            compress_pod: Optional[bool] = None,
                            schedule=None,
                            overlap_pod_reduce: Optional[bool] = None):
    """The reference's explicit-collective train step, run on every rank.

    Per rank, the step embeds the local batch shard, stages the decoder
    blocks through a :class:`repro_torch.dist.pipeline.PipelineSchedule`
    (``schedule`` / ``cfg.pipeline_schedule``: ``"gpipe"`` or ``"1f1b"``)
    microbatched over the ``pipe`` axis (each rank owns ``n_layers /
    pipe`` contiguous layers), differentiates the pipeline in place (the
    ring ``ppermute`` transposes to the backward ring), then reduces
    gradients: each leaf psums over the pipe/model axes it is not sharded
    on, everything pmeans over ``data``, and over the slow ``pod`` axis
    either :func:`repro_torch.dist.compress.compressed_psum` (bf16 wire
    format + error feedback, ``compress_pod``) or a plain f32 pmean.  With
    ``overlap_pod_reduce`` (default ``cfg.overlap_pod_reduce``) the
    compressed reduction is issued per gradient group, stage grads first;
    the results are bit-identical.

    A ``model`` mesh axis > 1 composes tensor parallelism into the stage
    bodies: attention/MLP weights shard per head/column over ``model``
    (:func:`repro_torch.dist.sharding.sharded_param_specs`), the blocks
    psum their partial projections in-stage, and glue stays replicated.
    Supported for the dense family with ``d_ff`` / ``n_heads`` /
    ``n_kv_heads`` divisible by the axis size.

    Remaining constraints (checked eagerly, :class:`PipelineStepError`):
    ``pipe >= 2`` on the mesh; family in dense/moe/ssm with a uniform
    layer stack divisible by ``pipe``.  ``mesh`` may be an
    ``AbstractMesh`` to validate; running needs the ranks' ``Mesh``.

    Returns ``train_step(state, batch) -> (state, metrics)`` with the
    contract of :func:`make_train_step`, where ``state`` holds this rank's
    blocks (``shard_tree`` of the global state by
    :func:`sharded_state_specs`) and ``batch`` is the global batch, of
    which each rank takes its data-parallel block.  ``state.ef`` must be
    :func:`init_ef_state` when the compressed path is active, else None.
    """
    sizes = shd.axis_sizes(mesh)
    n_stages = sizes.get("pipe", 1)
    tp = sizes.get("model", 1)
    if n_stages < 2:
        raise PipelineStepError("make_sharded_train_step needs a mesh 'pipe' "
                                f"axis of size >= 2, got {sizes}")
    if cfg.family not in ("dense", "moe", "ssm"):
        raise PipelineStepError(f"pipeline step: unsupported family "
                                f"{cfg.family}")
    if cfg.family == "moe" and cfg.first_dense_layers:
        raise PipelineStepError("pipeline step: moe configs with leading "
                                "dense layers are not stage-uniform")
    if cfg.n_layers % n_stages:
        raise PipelineStepError(f"n_layers={cfg.n_layers} not divisible by "
                                f"pipe={n_stages}")
    if tp > 1:
        if cfg.family != "dense":
            raise PipelineStepError(
                "tensor-parallel stage composition (model axis > 1) "
                f"supports the dense family only, got {cfg.family}")
        if cfg.mla:
            raise PipelineStepError("pipeline step: MLA attention has no "
                                    "explicit-TP path")
        if cfg.qk_norm:
            raise PipelineStepError(
                "pipeline step: qk_norm scales live inside the TP region "
                "and would need a model-axis grad reduction")
        for val, nm in ((cfg.d_ff, "d_ff"), (cfg.n_heads, "n_heads"),
                        (cfg.n_kv_heads, "n_kv_heads")):
            if val % tp:
                raise PipelineStepError(
                    f"{nm}={val} not divisible by model={tp} (head-/column-"
                    "granular TP sharding)")
    try:
        sched = get_schedule(schedule if schedule is not None
                             else cfg.pipeline_schedule)
    except ValueError as e:
        raise PipelineStepError(str(e)) from None
    n_micro = num_microbatches or cfg.pipeline_microbatches
    has_pod = sizes.get("pod", 1) > 1
    if compress_pod is None:
        compress_pod = cfg.compress_pod_grads
    compress_pod = bool(compress_pod and has_pod)
    if overlap_pod_reduce is None:
        overlap_pod_reduce = cfg.overlap_pod_reduce
    dp_total = sizes.get("pod", 1) * sizes.get("data", 1)
    stage_keys = tuple(shd.STAGE_KEYS)
    layers_per_stage = cfg.n_layers // n_stages
    windows_full = (lm.window_schedule(cfg)
                    if cfg.family in ("dense", "moe") else None)
    state_specs = sharded_state_specs(cfg, mesh, compress_pod)
    p_specs = state_specs.params
    bspec = shd.P(shd.dp_axes(mesh))

    # per-leaf reduction plans, read straight off the specs.  Gradients are
    # *partial* over every pipeline/TP axis the leaf is NOT sharded on
    # (the masked loss is owned by one (pipe, model) rank; each rank's
    # backward carries only its own compute's contribution), so assembly
    # psums over {pipe, model} minus the leaf's sharded axes.  The global
    # grad norm is the mirror image: leaves sharded over pipe/model psum
    # their squared sums over exactly those axes.
    def _spec_axes(sp) -> tuple:
        ents = []
        for e in tuple(sp):
            ents.extend(e if isinstance(e, (tuple, list)) else (e,))
        return tuple(a for a in ("pipe", "model") if a in ents)

    partial_axes = ("pipe", "model") if tp > 1 else ("pipe",)
    flat_norm_axes = [_spec_axes(sp) for sp in tree_leaves(p_specs)]
    flat_psum_axes = [tuple(a for a in partial_axes if a not in sharded)
                      for sharded in flat_norm_axes]

    def train_step(state: TrainState, batch: Dict):
        batch_size = batch["tokens"].shape[0]
        if batch_size % dp_total:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"pod*data={dp_total}")
        if (batch_size // dp_total) % n_micro:
            raise ValueError(f"local batch {batch_size // dp_total} not "
                             f"divisible by {n_micro} microbatches")
        if compress_pod and state.ef is None:
            raise ValueError("compressed pod reduction needs state.ef — "
                             "initialize it with init_ef_state(params, mesh)")
        ax = {a: mesh.axis(a) for a in mesh.axis_names}
        stage = ax["pipe"].index
        tp_axis = ax["model"] if tp > 1 else None
        wloc = (None if windows_full is None else
                windows_full[stage * layers_per_stage:
                             (stage + 1) * layers_per_stage])
        local = shd.shard_tree(batch, {k: bspec for k in batch}, mesh)

        def local_loss(params):
            tokens = local["tokens"]
            x = lm.embed_forward(params, tokens, cfg)
            mb = tokens.shape[0] // n_micro
            micro = x.reshape((n_micro, mb) + x.shape[1:])

            def stage_fn(w, h):
                return lm.stage_forward(cfg, w, h, windows=wloc,
                                        tp_axis=tp_axis)

            y = sched.run_local(stage_fn, params["layers"], micro,
                                n_stages=n_stages, axis=ax["pipe"],
                                replicate_out=False)
            y = y.reshape((tokens.shape[0],) + y.shape[2:])
            logits = lm.head_forward(params, y, cfg)
            nll = cross_entropy(logits, local["labels"])
            # only the last pipe rank holds real pipeline outputs; masking
            # the loss there makes the summed-over-ranks scalar equal ONE
            # copy of the shard loss, so backward collectives don't
            # over-count it.  Under TP every model rank replicates the
            # final stream, so the loss is owned by model rank 0 alone.
            owns = stage == n_stages - 1 and (tp_axis is None
                                             or tp_axis.index == 0)
            return torch.where(torch.tensor(owns, device=nll.device), nll,
                               torch.zeros_like(nll))

        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(state.params)]
        live = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            loss_part = local_loss(live)
        grads = list(torch.autograd.grad(loss_part, leaves))
        del live, leaves
        with torch.no_grad():
            grads = [col.psum(g, [ax[a] for a in axes]) if axes else g
                     for g, axes in zip(grads, flat_psum_axes)]
            loss = col.psum(loss_part.detach(),
                            [ax[a] for a in partial_axes])
            if "data" in sizes:
                grads = [col.pmean(g, ax["data"]) for g in grads]
                loss = col.pmean(loss, ax["data"])
            grads = tree_unflatten(state.params, grads)
            ef = state.ef
            if has_pod:
                loss = col.pmean(loss, ax["pod"])
                if compress_pod:
                    err = tree_map(lambda e: e[0], ef)
                    if overlap_pod_reduce:
                        order = ([k for k in grads if k in stage_keys]
                                 + [k for k in grads if k not in stage_keys])
                        grads, new_err = compress.compressed_psum_grouped(
                            grads, err, ax["pod"], order)
                    else:
                        grads, new_err = compress.compressed_psum(
                            grads, err, ax["pod"])
                    ef = tree_map(lambda e: e[None], new_err)
                else:
                    grads = tree_map(lambda g: col.pmean(g, ax["pod"]),
                                     grads)
        with spans.span(spans.OPTIM):
            with torch.no_grad():
                # true global grad norm from the per-leaf reduction plan
                gnorm = _global_norm(tree_leaves(grads), flat_norm_axes,
                                     mesh)
                grads = tree_unflatten(grads, _clip(tree_leaves(grads),
                                                    gnorm, opt))
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            with torch.no_grad():
                params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1, ef), metrics

    return train_step
