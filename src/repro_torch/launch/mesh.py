"""Meshes over ``torch.distributed``: one process per rank.

Port of ``repro/launch/mesh.py``.  The axis layout is the reference's
(outermost → innermost): ``pod`` (multi-pod replica groups), ``pipe``
(pipeline stages, carved out of the data-parallel dimension), ``data``
(within-pod DP), ``model`` (tensor parallelism); ``pod``/``pipe`` only
appear when their size is > 1.

Where the reference counts ``jax.devices()``, the port counts the ranks
of the initialised process group (``torchrun --nproc-per-node N``, or
:func:`run_ranks`).  A :class:`Mesh` is a
``torch.distributed.device_mesh.init_device_mesh`` over those ranks with
the reference's axis names, plus this rank's coordinate on each axis.
The backend follows from the layout (:func:`pick_backend`): ``nccl`` when
every rank has a GPU of its own, ``gloo`` on the CPU and when ranks share
a GPU (NCCL refuses two ranks on one device); gloo on CUDA tensors
stages every collective through the host
(:mod:`repro_torch.dist.collectives`).  A mesh's ``repr`` names its
backend and transport.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the reference's production layout: 16-way data x 16-way model a pod
_POD_DATA, _POD_MODEL = 16, 16
# how long a collective waits for its peers before the group gives up
_COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


class AbstractMesh:
    """A mesh's shape alone — ``shape`` ({axis: size}, in axis order) and
    ``axis_names`` — for the sharding rules and eager validation, as the
    reference's ``jax.sharding.AbstractMesh``."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class Mesh(AbstractMesh):
    """A mesh over the initialised process group: this rank's ``coords``
    ({axis: index}), ``device``, ``backend``, ``transport`` and, per axis,
    the process group and global ranks that join its peers."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device):
        super().__init__(shape, axis_names)
        from torch.distributed.device_mesh import init_device_mesh
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.transport = ("host-staged" if self.staged else
                          "nccl" if self.backend == "nccl" else "host")
        self.rank = dist.get_rank()
        self.device_mesh = init_device_mesh(
            self.device.type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        self.coords: Dict[str, int] = dict(
            zip(self.axis_names, self.device_mesh.get_coordinate()))
        # a host copy of the rank grid, read by :meth:`axis_ranks`: no
        # method of a mesh reads a tensor's value, so a mesh serves
        # under ``FakeTensorMode`` too (the dry run, launch.dryrun)
        self.grid = np.array(self.device_mesh.mesh.tolist(), dtype=np.int64)
        self._axes = {}

    def group(self, name: str):
        return self.device_mesh.get_group(name)

    def axis_ranks(self, names) -> Tuple[int, ...]:
        """The global ranks along axis ``names`` (a name, or several in
        mesh order) through this rank, by their combined coordinate,
        major to minor."""
        names = (names,) if isinstance(names, str) else tuple(names)
        index = tuple(slice(None) if a in names else self.coords[a]
                      for a in self.axis_names)
        return tuple(int(r) for r in self.grid[index].reshape(-1))

    def axis(self, name: str):
        """The bound :class:`repro_torch.dist.collectives.Axis` ``name``."""
        if name not in self._axes:
            from repro_torch.dist.collectives import Axis
            self._axes[name] = Axis(self, name)
        return self._axes[name]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, backend {self.backend}, transport "
                f"{self.transport})")


# ---------------------------------------------------------------------------
# shape arithmetic (the reference's, bit for bit)
# ---------------------------------------------------------------------------

def production_mesh_shape(*, multi_pod: bool = False, pipe: int = 1):
    """The shape arithmetic of :func:`make_production_mesh`:
    ``(shape, axis_names)``.  single-pod: (data=16, model=16) = 256 ranks;
    multi-pod: (pod=2, data=16, model=16) = 512; ``pipe > 1`` carves the
    pipeline axis out of the 16-way data dimension."""
    if _POD_DATA % pipe:
        raise ValueError(f"pipe={pipe} must divide the 16-way data axis")
    shape: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = ()
    if multi_pod:
        shape, axes = (2,), ("pod",)
    if pipe > 1:
        shape, axes = shape + (pipe,), axes + ("pipe",)
    shape += (_POD_DATA // pipe, _POD_MODEL)
    axes += ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, pipe: int = 1,
                         device=None) -> Mesh:
    """The reference's production mesh over 256 (512 multi-pod) ranks,
    built as :func:`make_host_mesh` builds its mesh."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod, pipe=pipe)
    return _make_mesh(shape, axes, device)


def host_mesh_shape(n_devices: int, *, model: int = 1,
                    data: Optional[int] = None, pipe: Optional[int] = None,
                    pods: Optional[int] = None):
    """Pure shape arithmetic behind :func:`make_host_mesh`.  Returns
    ``(shape, axis_names)``.

    ``pipe``/``pods`` compose with ``data``/``model`` instead of replacing
    them: the data dimension defaults to whatever ranks remain after the
    other axes take their share.
    """
    pipe = pipe or 1
    pods = pods or 1
    if data is None:
        denom = pods * pipe * model
        if n_devices % denom:
            raise ValueError(
                f"{n_devices} devices not divisible by pods*pipe*model="
                f"{denom}")
        data = n_devices // denom
    shape: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = ()
    if pods > 1:
        shape, axes = shape + (pods,), axes + ("pod",)
    if pipe > 1:
        shape, axes = shape + (pipe,), axes + ("pipe",)
    shape += (data, model)
    axes += ("data", "model")
    return shape, axes


# ---------------------------------------------------------------------------
# the process group and the mesh over it
# ---------------------------------------------------------------------------

def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, as torchrun sets
    it; the global rank where it is unset)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def pick_backend(device, local_world_size: int) -> str:
    """``nccl`` when ``device`` is a GPU and each of the host's
    ``local_world_size`` ranks has a GPU of its own, else ``gloo`` (the
    CPU, and ranks that share a GPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() \
        else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cpu`` where asked, else
    ``cuda:(local_rank % device_count)``; raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_world_size: Optional[int] = None
                     ) -> torch.device:
    """Initialise the default process group, with the backend
    :func:`pick_backend` names, and return this rank's device.  Without
    ``init_method`` it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``PORT``) and
    raises when there is none."""
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "a mesh needs one process per rank and none was started: "
                "run under torchrun --nproc-per-node N (e.g. torchrun "
                "--nproc-per-node 4 -m repro_torch.launch.train --pipe 2 "
                "--model 2)")
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
    if local_world_size is None:
        local_world_size = world_size
    if rank is not None and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(rank % local_world_size)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(pick_backend(dev, local_world_size),
                            init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=_COLLECTIVE_TIMEOUT)
    return dev


def require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call launch.mesh.init_distributed first, "
            "or run under torchrun --nproc-per-node N")


def _make_mesh(shape, axes, device) -> Mesh:
    require_group()
    return Mesh(shape, axes, rank_device(device))


def make_host_mesh(model: int = 1, data: Optional[int] = None,
                   pipe: Optional[int] = None, pods: Optional[int] = None,
                   device=None) -> Mesh:
    """A mesh over every rank of the initialised process group (the
    reference's "whatever devices exist").

    ``make_host_mesh(pipe=4)`` on 8 ranks builds ``(pipe=4, data=2,
    model=1)`` — the pipe axis composes with the others rather than
    silently dropping them.  ``device`` defaults to the card
    (``cuda:(local_rank % device_count)``); tests pass ``"cpu"``.
    """
    require_group()
    shape, axes = host_mesh_shape(dist.get_world_size(), model=model,
                                  data=data, pipe=pipe, pods=pods)
    return _make_mesh(shape, axes, device)


# ---------------------------------------------------------------------------
# spawning ranks from one process (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, init_method, device, args):
    """One spawned rank: ``fn`` between the group's setup and teardown.
    A rank that returns leaves by ``os._exit(0)`` once its group is
    destroyed, skipping the interpreter's teardown: under load gloo's
    native state has aborted a finished rank there ("terminate called
    without an active exception", no Python frame left), which failed a
    run whose work was done (ROADMAP §C)."""
    torch.set_num_threads(1)
    init_distributed(device, init_method=init_method, rank=rank,
                     world_size=world, local_world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn, world: int, *args, init_method: str, device="cpu",
              timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes on one host,
    each with the process group initialised at ``init_method`` (a
    ``file://`` path keeps concurrent runs apart) and its rank's device
    (``device="cuda"``: every rank on this host's cards).  Each rank
    takes one torch thread: 4 ranks sharing an H100 summed 40 KB from the
    card in 4.3 ms so, in 32.0 ms with a thread a core
    (``tools/collective_latency.py``).  A rank that
    raises makes this raise;
    ranks still running after ``timeout_s`` seconds are killed and this
    raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main,
                             args=(fn, world, init_method, str(device), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} "
                                   f"s: killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
