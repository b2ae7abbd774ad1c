"""Data parallelism over the evaluation batch: the dp mesh.

The counterpart of ``tfhe_fbs_map_tpu.parallel.mesh``.  A level of a
circuit is one batched bootstrap of ``bootstraps × V`` independent
ciphertexts, and nothing on the hot path needs another device's data, so
the one parallel axis is ``dp`` over the evaluation batch V: each position
of the mesh holds a slice of V on its device and runs the fused kernel on
it, with the keys replicated.

The JAX package's ``tp`` axis shards only the key contraction of its XLA
``matmul`` orientation, which the port does not have; under the fused
orientations JAX leaves tp unmapped.  So a mesh here is dp × 1, and
``tp != 1`` is refused.

A :class:`Mesh` is an ordered list of ``torch.device`` positions.  A device
may repeat: ``["cpu"] * 8`` stands in for eight devices on the CPU, and
``[cuda:0, cuda:0]`` runs two shards on one card.  Positions on one device
share that device's keys and plan tensors.  A mesh that spans processes
(:func:`.distributed.global_mesh`) lists this process's positions and
where they start among all ``dp``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.blind_rotate import FastKeys, functional_bootstrap_fast

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate",
           "shard_fast_keys", "sharded_bootstrap"]

NO_TP = ("tp={} is not supported: tp shards the key contraction of the "
         "JAX package's XLA matmul orientation, and no port orientation "
         "shards the key contraction (the fused kernels are dp-only)")


@dataclass(frozen=True)
class Mesh:
    """``dp`` positions over the evaluation batch.

    ``devices``: this process's positions, in batch order; ``first``: the
    index among all ``dp`` positions of ``devices[0]`` (0 unless the mesh
    spans processes).  Position i of dp holds evaluations
    ``[i·V/dp, (i+1)·V/dp)`` of a batch of V."""

    devices: tuple[torch.device, ...]
    dp: int
    first: int = 0

    def __post_init__(self):
        if not self.devices or self.first < 0 \
                or self.first + len(self.devices) > self.dp:
            raise ValueError(f"positions {self.first}.."
                             f"{self.first + len(self.devices) - 1} do not "
                             f"fit a dp axis of {self.dp}")

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": 1}

    @property
    def distinct(self) -> list[torch.device]:
        """This process's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))

    @property
    def spans_processes(self) -> bool:
        return len(self.devices) != self.dp


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its CUDA index spelled out (a bare
    ``"cuda"`` is the current device, which may change under the caller)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_tp(tp: int) -> None:
    if tp != 1:
        raise ValueError(NO_TP.format(tp))


def make_mesh(devices=None, dp: int | None = None, tp: int = 1) -> Mesh:
    """A dp mesh of this process over ``devices`` (one per position; a
    device may repeat).  Default: every visible CUDA device, or with ``dp``
    given, ``dp`` positions dealt round-robin over them (``dp=2`` on one
    card is ``[cuda:0, cuda:0]``).  Raises ValueError for ``tp != 1`` or a
    ``dp`` other than the number of devices given, RuntimeError when no
    CUDA device is visible and none are given."""
    check_tp(tp)
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices, e.g. ['cpu'] * 4")
        devices = [torch.device("cuda", i % count)
                   for i in range(count if dp is None else dp)]
    devices = tuple(_device(d) for d in devices)
    if dp is not None and dp != len(devices):
        raise ValueError(f"{len(devices)} devices cannot form mesh "
                         f"({dp}, {tp})")
    return Mesh(devices, len(devices))


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: int = 0
                ) -> list[torch.Tensor]:
    """This process's dp slices of the whole batch ``x`` along ``axis``,
    each a copy on its position's device."""
    v = x.shape[axis]
    if v % mesh.dp:
        raise ValueError(f"batch {v} must be divisible by the dp axis "
                         f"({mesh.dp})")
    per = v // mesh.dp
    return [x.narrow(axis, (mesh.first + i) * per, per)
            .to(dev, copy=True).contiguous()
            for i, dev in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` at every position: one copy a device, shared by its
    positions."""
    copies = {d: x.to(d) for d in mesh.distinct}
    return [copies[d] for d in mesh.devices]


def shard_fast_keys(mesh: Mesh, fast: FastKeys) -> dict[torch.device,
                                                        FastKeys]:
    """``fast`` on each of the mesh's devices, the same bytes (the fused
    kernels are dp-only, so every device holds all the key material)."""
    return {d: fast.to(d) for d in mesh.distinct}


def sharded_bootstrap(mesh: Mesh, fast: FastKeys):
    """Batched FBS over the mesh: a callable of this process's shards of
    ``big_cts``, ``tvs`` and ``posts`` (lists in position order, as
    :func:`shard_batch` makes them) returning the output shards.  Each
    position runs :func:`..ops.blind_rotate.functional_bootstrap_fast` on
    its slice with its device's copy of ``fast`` (:func:`shard_fast_keys`),
    so on CUDA one launch of the fused kernel a position."""
    keys = shard_fast_keys(mesh, fast)

    def fn(big_cts, tvs, posts) -> list[torch.Tensor]:
        if not len(big_cts) == len(tvs) == len(posts) == len(mesh.devices):
            raise ValueError(f"want {len(mesh.devices)} shards of each "
                             f"operand, got {len(big_cts)}, {len(tvs)}, "
                             f"{len(posts)}")
        out = []
        for dev, c, t, p in zip(mesh.devices, big_cts, tvs, posts):
            if c.device != dev:
                raise ValueError(f"a shard of position on {dev} lies on "
                                 f"{c.device}")
            out.append(functional_bootstrap_fast(keys[dev], c, t, p))
        return out

    return fn
