"""The data mesh: the port of ``ginfinity_tpu/parallel/mesh.py``.

The JAX package's ``--data-parallel`` is one process running SPMD over
every local device, with one ``("data",)`` axis: batches, corpora and
gradients shard over it, parameters replicate.  The port keeps that
contract in one process over a list of devices:

- a shard is a tensor on its own ``torch.device``;
- ``P("data")`` is a leading axis cut into contiguous equal blocks, in
  device order, after padding to a multiple of the mesh size;
- results are gathered onto the first device in shard order;
- a collective is an explicit sum in shard order (``pmean``), so a run
  repeats bit for bit.

Kernel launches are asynchronous per card, so one host thread enqueues
each shard's work in turn and the cards may run at once.  Whether they
do is not measured: that thread issues every shard's launches, and
launch-bound work (the MSA's posterior batches) issues more launches
as it shards.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ginfinity_tpu_torch.utils.device import resolve_device


def visible_devices(device: torch.device) -> list[torch.device]:
    """The devices a data mesh spans for a caller on ``device``: every
    visible card for a CUDA caller, ``device`` alone otherwise.  The one
    place the mesh learns the devices; the tests stand k CPU entries in
    for it, as the JAX tests run on 8 CPU devices."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


class DataMesh:
    """An ordered tuple of devices, one shard each."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where gathered results land."""
        return self.devices[0]

    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the mesh size."""
        return -(-n // self.size) * self.size

    def blocks(self, n: int) -> list[range]:
        """Shard ``s``'s items of ``n``: the ``s``-th contiguous block of
        ``padded(n) / size``, the padded tail dropped (so the last shards
        may hold fewer items, or none)."""
        per = self.padded(n) // self.size
        return [range(min(n, s * per), min(n, (s + 1) * per)) for s in range(self.size)]

    def split(self, x: torch.Tensor, non_blocking: bool = False) -> list[torch.Tensor]:
        """``x``'s leading axis, a multiple of the mesh size, as equal
        contiguous blocks, block ``s`` on device ``s`` (copied as
        ``Tensor.to`` copies with ``non_blocking``)."""
        if x.shape[0] % self.size:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple of {self.size}")
        per = x.shape[0] // self.size
        return [x[s * per:(s + 1) * per].to(d, non_blocking=non_blocking)
                for s, d in enumerate(self.devices)]

    def gather(self, parts: Sequence[torch.Tensor], n: int | None = None) -> torch.Tensor:
        """Shard blocks concatenated in shard order on the first device,
        cut to the first ``n`` rows (the padded tail dropped)."""
        parts = [p.to(self.first) for p in parts]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out if n is None else out[:n]

    def replicate(self, make: Callable[[torch.device], object]) -> list:
        """``make(device)`` once per distinct device, listed per shard (two
        shards on one device share one replica)."""
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def mean(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """``pmean``: the shards' values summed in shard order on the first
        device, over the mesh size."""
        acc = values[0].to(self.first)
        for v in values[1:]:
            acc = acc + v.to(self.first)
        return acc / self.size


def make_data_mesh(n_devices: int | None = None, device=None) -> DataMesh:
    """A mesh over the devices visible to a caller on ``device`` (the CUDA
    device unless ``"cpu"`` is asked for), the first ``n_devices`` of
    them when given."""
    devs = visible_devices(resolve_device(device))
    if n_devices is not None:
        devs = devs[:n_devices]
    return DataMesh(devs)


def data_parallel_mesh(device) -> DataMesh | None:
    """The mesh of a CLI's ``--data-parallel``: every visible device when
    there are several, ``None`` (run unsharded, as the JAX CLIs do) when
    one is visible."""
    mesh = make_data_mesh(device=device)
    return mesh if mesh.size > 1 else None
