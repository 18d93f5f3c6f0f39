"""Pod meshes on one card (the port's ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh`` objects: a host mesh over the
machine's devices for tests and examples, and the production meshes,
256 chips as (data=16, model=16) or 2 pods of them as (pod=2, data=16,
model=16), FSDP over the ``data`` axis.  The port runs on one H100, where
NCCL will not place two ranks on one device, so a pod is a CUDA stream:
:class:`PodMesh` carries the axis names and sizes (the ``axis_names`` /
``shape`` surface the reference's class-sharded step reads), the device,
and one ``torch.cuda.Stream`` per pod, made on first use.  On the CPU a
pod has no stream and the pods run in turn.

The production meshes have no one-card counterpart: they shard the
params and optimizer state over hundreds of chips, and the port holds
them whole on one card.  :func:`make_production_mesh` says so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def make_host_mesh(*, model: int = 1, data: int = 1, pod: int = 0, device="cuda") -> PodMesh:
    """A mesh on one device: ``(pod, data, model)`` with a pod axis, else
    ``(data, model)``, as the reference's ``make_host_mesh``."""

    if model != 1 or data != 1:
        raise ValueError(f"data={data}, model={model}: on one card the data and model "
                         "axes have extent 1 (nothing is sharded over them)")
    device = torch.device(device)
    if pod:
        return PodMesh(("pod", "data", "model"), (int(pod), 1, 1), device)
    return PodMesh(("data", "model"), (1, 1), device)


def resolve_pods(mode: str, asym, device) -> Optional[PodMesh]:
    """The pod mesh of the class-sharded mixed step, or ``None`` for the
    single-program step, for ``class_sharded=mode``: the one place the
    engine, the one-shot serving path and the train CLI decide it.

    * ``"on"``: ``asym.n_pods`` pods on ``device``, each a CUDA stream
      there (on the CPU the pods run in turn); a ``ValueError`` with one
      device class.
    * ``"auto"``: ``None``.  The reference's ``auto`` takes the mixed
      step when every pod can have a device of its own.  The port never
      places pods on separate cards: they share ``device`` as streams,
      issued one after the other, so the mixed step costs what its pods
      cost in turn, on any number of cards.  ``auto`` never takes it.
    * ``"off"``: ``None``.
    """

    if mode not in ("auto", "on", "off"):
        raise ValueError(f"class_sharded={mode!r}")
    if mode != "on":
        return None
    if len(asym.classes) < 2:
        raise ValueError(f"class_sharded='on' needs more than one device class, "
                         f"have {len(asym.classes)}")
    return make_host_mesh(pod=asym.n_pods, device=device)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 / 2x16x16 TPU meshes (FSDP over 256 or 512
    chips) have no one-card counterpart."""

    shape = "2x16x16" if multi_pod else "16x16"
    raise ValueError(
        f"the {shape} production mesh shards the params and optimizer state (FSDP) over "
        f"{512 if multi_pod else 256} TPU chips; the port runs on one card and has no "
        "counterpart (use the host mesh)"
    )


__all__ = ["PodMesh", "make_host_mesh", "make_production_mesh", "resolve_pods"]
