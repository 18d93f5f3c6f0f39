"""Meshes (the port's ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh`` objects: a host mesh over the
machine's devices for tests and examples, and the production meshes, 256
chips as (data=16, model=16) or 2 pods of them as (pod=2, data=16,
model=16).  The port has two kinds:

  * :class:`RankMesh` — a ``(data, model)`` or ``(pod, data, model)``
    mesh over the ranks of an initialised ``torch.distributed`` process
    group, with one process group per axis (and one over the dp axes
    together) made when the mesh is built.  A rank runs on
    ``cuda:(local_rank % device_count)`` (or the CPU), its local rank the
    launcher's ``LOCAL_RANK`` or else its rank, and the sharded step
    (``distributed/spmd.py``) calls the collectives of
    ``distributed/collectives.py`` on these groups.  An *abstract* mesh
    has sizes and a rank but no groups: the dry-run runs a cell as its
    rank 0 on the ``meta`` device, where a collective only makes shapes.
  * :class:`PodMesh` — the class-sharded step's pods on one card: the
    axis names and sizes, the device, and one ``torch.cuda.Stream`` per
    pod, made on first use (on the CPU the pods run in turn).

The class-sharded step's pods are ranks (a rank a pod, the reference's
device a pod) on a :class:`RankMesh` with a ``pod`` axis, or streams in
one process on a :class:`PodMesh`.  :func:`make_host_mesh` gives the
rank mesh under an initialised process group whose world is ``pod · data
· model > 1``, the :class:`PodMesh` when ``data`` and ``model`` are 1
otherwise (one process, or a world of 1), and a :class:`RankMesh` when
``data`` or ``model`` exceed 1; :func:`resolve_pods` decides which the
class-sharded step takes (:func:`pod_route` is its rule);
:func:`make_production_mesh` the 16x16 / 2x16x16 mesh, real under a
launcher with that world and abstract otherwise.

The backend is decided per node: ``nccl`` when the ranks on a node
(a launcher's ``LOCAL_WORLD_SIZE``, else the world) have a card each, and
``gloo`` otherwise (NCCL refuses two ranks on one device); the choice is
printed.  Under ``gloo`` a collective on CUDA tensors stages them through
host memory (``collectives._staged``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import sys
import tempfile
import traceback
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(eq=False)
class PodMesh:
    """Axis names and sizes, the device, and one stream per pod.

    Only the ``pod`` axis may exceed 1: on one card nothing is sharded
    over ``data`` or ``model``.
    """

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    _streams: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}``, in axis order (as ``jax.sharding.Mesh.shape``)."""

        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_pods(self) -> int:
        return self.shape.get("pod", 1)

    def pod_streams(self) -> list:
        """One ``torch.cuda.Stream`` per pod on a CUDA device (made on the
        first call, then reused; raises where no stream can be made), and
        ``None`` per pod on the CPU."""

        if self.device.type != "cuda":
            return [None] * self.n_pods
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device) for _ in range(self.n_pods)]
        return self._streams


def _axes_of(pod: int) -> tuple:
    return ("pod", "data", "model") if pod else ("data", "model")


def _world() -> int:
    """The initialised process group's world, else 1."""

    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_rank() -> int:
    """This process's rank: the initialised process group's, else a
    launcher's ``RANK``, else 0 (the one process that prints a summary)."""

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def make_host_mesh(*, model: int = 1, data: int = 1, pod: int = 0, device="cuda"):
    """``(pod, data, model)`` with a pod axis, else ``(data, model)``, as
    the reference's ``make_host_mesh``.

    A :class:`RankMesh` over the ranks of the initialised process group
    when its world is ``pod · data · model > 1`` with a pod axis (a rank a
    pod, each pod ``data · model`` ranks wide), or when ``data`` or
    ``model`` exceed 1 (whose world must then match); each rank on
    ``cuda:(rank % device_count)`` for ``device="cuda"``.  Otherwise, with
    ``data == model == 1``, a :class:`PodMesh` on ``device`` (the
    class-sharded step's pods as streams, or the one-process default)."""

    sizes = ((int(pod),) if pod else ()) + (int(data), int(model))
    world = 1
    for n in sizes:
        world *= n
    if model == 1 and data == 1 and not (pod and world > 1 and _world() == world):
        device = torch.device(device)
        if pod:
            return PodMesh(("pod", "data", "model"), (int(pod), 1, 1), device)
        return PodMesh(("data", "model"), (1, 1), device)
    return RankMesh.over_world(_axes_of(pod), sizes, device=device)


def pod_route(mode: str, n_classes: int, n_pods: int, world: int, transport: Optional[str]):
    """The class-sharded step's route for ``class_sharded=mode``:
    ``"ranks"`` (a rank a pod), ``"streams"`` (the pods as streams in one
    process) or ``None`` (the single-program step).  ``world`` is the
    process group's (1 without one), ``transport`` the backend
    ``choose_backend`` gives its ranks (``None`` without a group).

    * ``"on"``: ranks under a world of ``n_pods``, streams in one process;
      any other world raises a ``ValueError`` naming both, as does one
      device class.
    * ``"auto"``: ranks only where the world is ``n_pods`` ranks and each
      has a card of its own (``nccl``): the reference's ``auto`` takes the
      mixed step when ``jax.device_count() >= n_pods``.  Everywhere else
      ``None``: pods sharing a card, as streams or as ``gloo`` ranks, run
      one after the other and cost what their pods cost in turn.
    * ``"off"``: ``None``.
    """

    if mode not in ("auto", "on", "off"):
        raise ValueError(f"class_sharded={mode!r}")
    if mode == "off":
        return None
    if n_classes < 2:
        if mode == "on":
            raise ValueError(f"class_sharded='on' needs more than one device class, "
                             f"have {n_classes}")
        return None
    if mode == "on":
        if world == 1:
            return "streams"
        if world != n_pods:
            raise ValueError(f"class_sharded='on' runs a rank a pod: {n_pods} pods need a world "
                             f"of {n_pods} ranks; the process group has {world}")
        return "ranks"
    return "ranks" if world == n_pods > 1 and transport == "nccl" else None


def resolve_pods(mode: str, asym, device):
    """The pod mesh of the class-sharded mixed step, or ``None`` for the
    single-program step, for ``class_sharded=mode``: the one place the
    engine, the one-shot serving path and the train CLI decide it, by
    :func:`pod_route` (the choice is printed to stderr).

    The world is the initialised process group's, or a launcher's
    (``torchrun`` sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), whose group is initialised here when the route
    takes ranks.  Ranks give a :class:`RankMesh` with a ``pod`` axis of
    ``asym.n_pods`` (``data = model = 1``), each rank on its own card or
    sharing ``device``'s; streams give a :class:`PodMesh` on ``device``.
    A rank that cannot make its process group fails the call: nothing
    falls back to streams inside a world of ranks.
    """

    import torch.distributed as dist

    device = torch.device(device)
    initialised = dist.is_available() and dist.is_initialized()
    if initialised:
        world, rank = dist.get_world_size(), dist.get_rank()
        transport = dist.get_backend()
    else:
        world, rank = int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0"))
        transport = choose_backend(rank, world, device=device, launcher=True)[0] \
            if world > 1 else None
    route = pod_route(mode, len(asym.classes), asym.n_pods, world, transport)
    if route == "ranks" and not initialised:
        init_ranks(rank, world, device=device)
    if rank == 0 and (mode == "on" or world > 1):
        how = {"ranks": f"pods as ranks ({world} over {transport}, a rank a pod)",
               "streams": f"pods as streams on {device}",
               None: "the single-program step"}[route]
        print(f"class-sharded step ({mode}): {how}", file=sys.stderr, flush=True)
    if route is None:
        return None
    return make_host_mesh(pod=asym.n_pods, device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: 256 ranks as (data=16, model=16),
    or 512 as (pod=2, data=16, model=16).

    Real when this process is one rank of a world of that size: an
    initialised process group, or a launcher's environment (``torchrun``
    sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
    initialises one here.  Otherwise abstract: rank 0's sizes, no groups,
    on the ``meta`` device (the dry-run's)."""

    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in sizes:
        world *= n
    import torch.distributed as dist

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) == world:
        init_ranks(int(os.environ["RANK"]), world, device=device)
    if dist.is_initialized() and dist.get_world_size() == world:
        return RankMesh.over_world(axes, sizes, device=device)
    return RankMesh.abstract(axes, sizes)


# ---------------------------------------------------------------------------
# Rank meshes over a torch.distributed process group
# ---------------------------------------------------------------------------


def _mesh_coords(sizes: Sequence[int]) -> list:
    """Every rank's coordinates, rank-major (rank = row-major index)."""

    return list(itertools.product(*(range(n) for n in sizes)))


@dataclasses.dataclass(eq=False)
class RankMesh:
    """A mesh of ``torch.distributed`` ranks: axis names and sizes, this
    rank and its coordinates, its device, the process group's backend
    (``transport``: ``nccl`` or ``gloo``), and one process group per set
    of axes the step reduces over (each single axis of size above 1, the
    dp axes together, every axis).  ``transport is None`` makes it abstract (:meth:`abstract`): no groups, and the collectives only
    make shapes."""

    axis_names: tuple
    axis_sizes: tuple
    rank: int
    device: torch.device
    transport: Optional[str] = None
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, in axis order (as ``jax.sharding.Mesh.shape``)."""

        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def world(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def is_abstract(self) -> bool:
        return self.transport is None

    @functools.cached_property
    def coords(self) -> tuple:
        """This rank's coordinates, one per axis."""

        return _mesh_coords(self.axis_sizes)[self.rank]

    @property
    def n_pods(self) -> int:
        return self.shape.get("pod", 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""

        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def reduced_axes(self, axes) -> tuple:
        """``axes`` (a name, a tuple or ``None``) as a tuple in mesh order,
        without the axes of size 1 or not in the mesh."""

        if axes is None:
            return ()
        axes = axes if isinstance(axes, tuple) else (axes,)
        return tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)

    def size(self, axes) -> int:
        n = 1
        for a in self.reduced_axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its group rank)."""

        i = 0
        for a in self.reduced_axes(axes):
            i = i * self.shape[a] + self.coord(a)
        return i

    def group(self, axes):
        return self.groups[self.reduced_axes(axes)]

    def barrier(self) -> None:
        if not self.is_abstract:
            import torch.distributed as dist

            dist.barrier(group=self.groups[self.reduced_axes(tuple(self.axis_names))])

    @classmethod
    def abstract(cls, axis_names, axis_sizes, *, rank: int = 0, device="meta") -> "RankMesh":
        return cls(tuple(axis_names), tuple(int(n) for n in axis_sizes), int(rank),
                   torch.device(device))

    @classmethod
    def over_world(cls, axis_names, axis_sizes, *, device="cuda") -> "RankMesh":
        """The mesh over the initialised process group's ranks, its groups
        made here (every rank must call this, in the same order)."""

        import torch.distributed as dist

        if not dist.is_initialized():
            raise ValueError(f"a {'x'.join(map(str, axis_sizes))} mesh needs an initialised "
                             "process group (launch.mesh.init_ranks or a launcher); there is none")
        world, rank = dist.get_world_size(), dist.get_rank()
        device = torch.device(device)
        if device.type == "cuda":  # the card init_ranks set for this rank
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = cls(tuple(axis_names), tuple(int(n) for n in axis_sizes), rank, device,
                   dist.get_backend())
        if mesh.world != world:
            raise ValueError(f"a {'x'.join(map(str, axis_sizes))} mesh needs {mesh.world} ranks; "
                             f"the process group has {world}")
        coords = _mesh_coords(mesh.axis_sizes)
        wanted = {mesh.reduced_axes((a,)) for a in axis_names}
        wanted |= {mesh.reduced_axes(("pod", "data")), mesh.reduced_axes(tuple(axis_names))}
        for axes in sorted(a for a in wanted if a):
            idx = [axis_names.index(a) for a in axes]
            blocks: dict = {}
            for r, c in enumerate(coords):
                key = tuple(v for i, v in enumerate(c) if i not in idx)
                blocks.setdefault(key, []).append(r)
            for ranks in blocks.values():  # every rank makes every group, in one order
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[axes] = g
        return mesh


def rank_device(local_rank: int, device="cuda") -> torch.device:
    """The device of the rank with index ``local_rank`` on its node:
    ``cuda:(local_rank % device_count)``, or ``device`` as given when it is
    not CUDA."""

    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(rank: int, world: int, *, device="cuda", launcher: bool = False):
    """``(backend, local_rank, why)`` for ``rank`` of ``world``.

    Decided per node: ``nccl`` when the ranks on this node have a card
    each, else ``gloo``.  Under a launcher (``env://``) its
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` say which ranks share this node;
    without one every rank runs on this node."""

    device = torch.device(device)
    local_rank, per_node = rank, world
    if launcher and "LOCAL_WORLD_SIZE" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
        per_node = int(os.environ["LOCAL_WORLD_SIZE"])
    if device.type != "cuda":
        return "gloo", local_rank, "ranks on the CPU"
    cards = torch.cuda.device_count()
    if per_node <= cards:
        return "nccl", local_rank, f"{per_node} rank(s) a node, each with a card of its own"
    return "gloo", local_rank, f"{per_node} ranks a node share {cards} card(s)"


def init_ranks(rank: int, world: int, *, device="cuda", store_path: Optional[str] = None):
    """Initialise this process as ``rank`` of ``world`` on the backend
    ``choose_backend`` picks (printed to stderr).  Rendezvous through a
    ``FileStore`` at ``store_path``, or the launcher's environment
    (``env://``) without one."""

    import warnings

    import torch.distributed as dist

    device = torch.device(device)
    backend, local_rank, why = choose_backend(rank, world, device=device,
                                              launcher=store_path is None)
    if rank == 0:
        print(f"torch.distributed: backend {backend} for {world} ranks ({why})", file=sys.stderr,
              flush=True)
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(local_rank, device))
    # all_gather_into_tensor / reduce_scatter_tensor are deprecated in
    # newer torch in favour of names older releases lack.
    warnings.filterwarnings("ignore", message=r".*is deprecated\. Please use .*_single")
    kw = dict(backend=backend, rank=rank, world_size=world)
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)
    return backend


def _rank_main(target, rank, world, device, store_path, out_dir, args):
    torch.set_num_threads(1)
    try:
        init_ranks(rank, world, device=device, store_path=store_path)
        result = target(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:  # recorded for the parent, then re-raised
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target: Callable, world: int, *args, device="cpu", timeout: float = 120.0) -> list:
    """Run ``target(rank, *args)`` in ``world`` spawned processes, each
    one rank of a process group (a ``FileStore`` in a temporary
    directory); returns
    the ranks' results in rank order.  ``target`` and ``args`` are sent by
    pickling (``target`` by import path).  A rank that raises, exits or
    outlives ``timeout`` seconds fails the call; every process is stopped
    before it returns."""

    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(target, r, world, device, store, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            import time

            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            errs = []
            for r, p in enumerate(procs):
                err = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
                elif p.is_alive():
                    errs.append(f"rank {r}: still running after {timeout:.0f} s")
                elif p.exitcode != 0:
                    errs.append(f"rank {r}: exit code {p.exitcode}")
            if errs:
                raise RuntimeError("spawned ranks failed:\n" + "\n".join(errs))
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)


__all__ = ["PodMesh", "RankMesh", "choose_backend", "init_ranks", "make_host_mesh",
           "make_production_mesh", "pod_route", "process_rank", "rank_device", "resolve_pods",
           "spawn_ranks"]
