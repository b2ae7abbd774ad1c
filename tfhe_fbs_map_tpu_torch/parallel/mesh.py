"""The (dp, tp) mesh: data parallelism over the evaluation batch, and the
``"matmul"`` orientation's key contraction split over tp.

The counterpart of ``tfhe_fbs_map_tpu.parallel.mesh``.  A level of a
circuit is one batched bootstrap of ``bootstraps × V`` independent
ciphertexts, so ``dp`` splits V: each dp group holds a slice of V on its
devices.  ``tp`` splits the key contraction of the ``"matmul"``
orientation, as the JAX package shards it: each tp position of a group
holds a contiguous slice [n, D, T/tp] of every step's key matrix and its
share of the key switch's rows (:func:`shard_fast_keys`), runs the same
ciphertexts, and the group's partial products are summed once a CMux step
and once a key switch (:func:`..ops.blind_rotate.bootstrap_matmul`).  The
fused kernels are dp-only: under them the keys replicate and tp > 1 is
refused (JAX leaves tp unmapped there).

A :class:`Mesh` is an ordered list of ``torch.device`` positions, dp-major
with tp innermost, as the JAX package reshapes its devices to (dp, tp).  A
device may repeat: ``["cpu"] * 8`` stands in for eight devices on the CPU,
and ``[cuda:0, cuda:0]`` runs two positions on one card.  Positions on one
device share that device's keys and plan tensors (and, under tp, each
slice of the keys).  A mesh that spans processes
(:func:`.distributed.global_mesh`) lists this process's positions and the
dp group they start at; a tp group never spans processes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.blind_rotate import (FastKeys, bootstrap_matmul,
                                functional_bootstrap_fast,
                                shard_contraction)
from ..optimizer.runtime_model import launch_choice

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate",
           "shard_fast_keys", "sharded_bootstrap"]

NO_TP = ("tp={} is not supported by {}: tp shards the key contraction of "
         "the matmul orientation alone (--orientation matmul), and {} is "
         "dp-only, its keys replicated")


@dataclass(frozen=True)
class Mesh:
    """``dp`` groups over the evaluation batch, ``tp`` positions a group.

    ``devices``: this process's positions, dp-major with tp innermost
    (position i is tp index i % tp of group ``first`` + i // tp);
    ``first``: the dp index of this process's first group (0 unless the
    mesh spans processes).  Group g holds evaluations ``[g·V/dp,
    (g+1)·V/dp)`` of a batch of V, at each of its positions."""

    devices: tuple[torch.device, ...]
    dp: int
    first: int = 0
    tp: int = 1

    def __post_init__(self):
        if self.tp < 1 or len(self.devices) % self.tp:
            raise ValueError(f"{len(self.devices)} positions do not form "
                             f"groups of tp={self.tp}")
        groups = len(self.devices) // self.tp
        if not self.devices or self.first < 0 \
                or self.first + groups > self.dp:
            raise ValueError(f"groups {self.first}.."
                             f"{self.first + groups - 1} do not fit a dp "
                             f"axis of {self.dp}")

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def distinct(self) -> list[torch.device]:
        """This process's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))

    @property
    def spans_processes(self) -> bool:
        return len(self.devices) != self.dp * self.tp

    def groups(self, xs) -> list[list]:
        """``xs`` (one item a position) cut into this process's dp groups,
        each its tp positions in order."""
        xs = list(xs)
        return [xs[i:i + self.tp] for i in range(0, len(xs), self.tp)]

    def leaders(self, xs) -> list:
        """The item of each group's first tp position: under tp every
        position of a group holds the same outputs, read from its first."""
        return list(xs)[::self.tp]


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its CUDA index spelled out (a bare
    ``"cuda"`` is the current device, which may change under the caller)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def check_tp(tp: int, orientation: str | None = None) -> None:
    """Raise ValueError for a tp axis below 1, or above 1 under any
    ``orientation`` but ``"matmul"`` (None: the generic bootstrap)."""
    if tp < 1:
        raise ValueError(f"tp={tp}: the tp axis has at least one position")
    if tp > 1 and orientation != "matmul":
        what = (f"--orientation {orientation}" if orientation
                else "the generic bootstrap")
        raise ValueError(NO_TP.format(tp, what, what))


def make_mesh(devices=None, dp: int | None = None, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh of this process over ``devices`` (one a position,
    dp-major; a device may repeat).  Default: every visible CUDA device,
    or with ``dp`` given, dp·tp positions dealt round-robin over them
    (``dp=2`` on one card is ``[cuda:0, cuda:0]``, ``tp=2`` too).  Raises
    ValueError when dp·tp is not the number of devices given (dp defaults
    to that number over tp), RuntimeError when no CUDA device is visible
    and none are given."""
    if tp < 1:
        raise ValueError(f"tp={tp}: the tp axis has at least one position")
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices, e.g. ['cpu'] * 4")
        devices = [torch.device("cuda", i % count)
                   for i in range(count if dp is None else dp * tp)]
    devices = tuple(_device(d) for d in devices)
    if dp is None:
        dp = len(devices) // tp
    if dp < 1 or dp * tp != len(devices):
        raise ValueError(f"{len(devices)} devices cannot form mesh "
                         f"({dp}, {tp})")
    return Mesh(devices, dp, 0, tp)


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: int = 0
                ) -> list[torch.Tensor]:
    """This process's slices of the whole batch ``x`` along ``axis``, split
    over dp and repeated over tp: each a copy on its position's device."""
    v = x.shape[axis]
    if v % mesh.dp:
        raise ValueError(f"batch {v} must be divisible by the dp axis "
                         f"({mesh.dp})")
    per = v // mesh.dp
    return [x.narrow(axis, (mesh.first + i // mesh.tp) * per, per)
            .to(dev, copy=True).contiguous()
            for i, dev in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` at every position: one copy a device, shared by its
    positions."""
    copies = {d: x.to(d) for d in mesh.distinct}
    return [copies[d] for d in mesh.devices]


def shard_fast_keys(mesh: Mesh, fast: FastKeys) -> dict:
    """``fast`` laid out for the mesh, one copy a device and slice.

    tp = 1: ``{device: keys}``, the same bytes on each device.  tp > 1
    (``"matmul"`` only): ``{(device, tp index): keys}``, slice tp index of
    the key contractions (:func:`..ops.blind_rotate.shard_contraction`), cut
    once on ``fast``'s device and copied to the device.  Raises ValueError
    for tp > 1 under the fused orientations."""
    check_tp(mesh.tp, fast.orientation)
    if mesh.tp == 1:
        return {d: fast.to(d) for d in mesh.distinct}
    slices = [shard_contraction(fast, j, mesh.tp) for j in range(mesh.tp)]
    keys = {}
    for i, dev in enumerate(mesh.devices):
        j = i % mesh.tp
        if (dev, j) not in keys:
            keys[(dev, j)] = slices[j].to(dev)
    return keys


def position_keys(mesh: Mesh, fast: FastKeys) -> list[FastKeys]:
    """The keys of each of this process's positions, from
    :func:`shard_fast_keys`."""
    keys = shard_fast_keys(mesh, fast)
    if mesh.tp == 1:
        return [keys[d] for d in mesh.devices]
    return [keys[(d, i % mesh.tp)] for i, d in enumerate(mesh.devices)]


def group_bootstrap(keys: list[FastKeys], big_cts, tvs, posts
                    ) -> list[torch.Tensor]:
    """One dp group's batched FBS, one output a position: its tp
    positions' partial products summed (``"matmul"``), or for one position
    its fused kernel's launch, on the route and plan the cost model
    chooses for it (:func:`..optimizer.runtime_model.launch_choice`)."""
    if keys[0].orientation == "matmul":
        return bootstrap_matmul(keys, list(big_cts), list(tvs), list(posts))
    (k,), (c,), (t,), (p,) = keys, big_cts, tvs, posts
    choice = launch_choice(k.params, c.shape[0], 1, k.orientation, k.limbs,
                           k.route, c.is_cuda)
    return [functional_bootstrap_fast(k, c, t, p, None, choice)]


def sharded_bootstrap(mesh: Mesh, fast: FastKeys):
    """Batched FBS over the mesh: a callable of this process's shards of
    ``big_cts``, ``tvs`` and ``posts`` (lists in position order, as
    :func:`shard_batch` makes them) returning the output shards, one a
    position (the positions of a tp group return the same ones).  Each dp
    group runs :func:`group_bootstrap` with its positions' keys
    (:func:`shard_fast_keys`): under the fused orientations one launch of
    the fused kernel a position, under ``"matmul"`` the group's
    contraction split over its tp positions."""
    keys = position_keys(mesh, fast)

    def fn(big_cts, tvs, posts) -> list[torch.Tensor]:
        if not len(big_cts) == len(tvs) == len(posts) == len(mesh.devices):
            raise ValueError(f"want {len(mesh.devices)} shards of each "
                             f"operand, got {len(big_cts)}, {len(tvs)}, "
                             f"{len(posts)}")
        for dev, c in zip(mesh.devices, big_cts):
            if c.device != dev:
                raise ValueError(f"a shard of position on {dev} lies on "
                                 f"{c.device}")
        out = []
        for group in zip(*(mesh.groups(x)
                           for x in (keys, big_cts, tvs, posts))):
            out += group_bootstrap(*group)
        return out

    return fn
