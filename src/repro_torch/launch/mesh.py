"""Meshes of ``torch.distributed`` ranks (PyTorch port of
``repro.launch.mesh``).

``make_mesh(shape, axes, device=None)`` stands for ``jax.make_mesh``: the
world's ranks laid out row-major over named axes, with a process group
for every set of axes (the ranks that share a rank's coordinates on the
other axes).  The caller initialises ``torch.distributed`` first (an
address, a world size and a rank of its own; nothing on the machine tells
a program of a cluster).  A mesh runs on ``cuda`` with NCCL unless the
caller passes ``device="cpu"`` (gloo); there is no fallback from one to
the other.  A ``fake`` process group (the dry run's world of 256 or 512
ranks, ``torch.testing._internal.distributed.fake_pg``) takes the
caller's device unchecked.

Building a mesh creates process groups, and ``new_group`` is collective
over the world: every rank of the world builds every mesh, in the same
order, the ranks a ``degrade_mesh`` drops included.  Groups are shared
between meshes over the same ranks.

The production 16x16 / 2x16x16 shapes raise unless the world has 256 /
512 ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

# process groups by their sorted ranks, for the default group they belong
# to (a new world starts a new table): a mesh over ranks that a group
# already joins (a second mesh of the same shape, a degraded mesh's
# survivors) reuses it instead of another new_group, which every rank of
# the world would have to call
_GROUPS: Dict[tuple, object] = {}
_GROUPS_WORLD: list = [None]


def _new_group(ranks: Tuple[int, ...]):
    world = tdist.group.WORLD
    if _GROUPS_WORLD[0] is not world:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = world
    if ranks not in _GROUPS:
        _GROUPS[ranks] = tdist.new_group(ranks=list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Ranks ``devices`` (an int array) over ``axis_names``; the port's
    ``jax.sharding.Mesh``.  ``shape`` maps each axis to its size; this
    rank's ``coords`` map each axis to its index (None when the rank is
    not on the mesh); ``device`` is the rank's device."""

    def __init__(self, devices, axis_names: Sequence[str],
                 device: torch.device):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device = device
        rank = tdist.get_rank()
        pos = np.argwhere(self.devices == rank)
        self.coords = (dict(zip(self.axis_names, (int(i) for i in pos[0])))
                       if len(pos) else None)
        self._groups: Dict[tuple, object] = {}
        # every rank walks every group in the same order (new_group is
        # collective over the world) and keeps the ones it belongs to
        names = self.axis_names
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), r):
                rest = [i for i in range(len(names)) if i not in axes]
                moved = np.moveaxis(self.devices, rest + list(axes),
                                    list(range(len(names))))
                blocks = moved.reshape(
                    -1, int(np.prod([self.devices.shape[i] for i in axes])))
                for block in blocks:
                    pg = _new_group(tuple(sorted(int(b) for b in block)))
                    if rank in block:
                        self._groups[tuple(names[i] for i in axes)] = pg

    def group(self, axes: Tuple[str, ...]):
        """The group of ``axes`` (in mesh order) holding this rank."""
        if self.coords is None:
            raise RuntimeError("this rank is not on the mesh")
        order = tuple(a for a in self.axis_names if a in axes)
        if order != tuple(axes):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return self._groups[tuple(axes)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _mesh_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                               "device='cpu' for a gloo mesh on the CPU")
        dev = torch.device("cuda", tdist.get_rank()
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    """The world's ranks row-major over ``axes`` of sizes ``shape``, on
    ``cuda`` (NCCL) unless ``device`` names another (``"cpu"``: gloo; on
    a ``fake`` process group, ``device`` as given)."""
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first")
    backend = str(tdist.get_backend())
    if backend == "fake":
        # a fake world (``launch.dryrun``) moves no bytes: the mesh takes
        # the caller's device as it is
        dev = torch.device("cuda" if device is None else device)
    else:
        dev = _mesh_device(device)
        want = "nccl" if dev.type == "cuda" else "gloo"
        if want not in backend:
            raise ValueError(f"a {dev.type} mesh needs the {want} backend; "
                             f"the process group runs {backend}")
    n = int(np.prod(shape))
    if n != tdist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {tdist.get_world_size()}")
    return Mesh(np.arange(n).reshape(tuple(shape)), axes, dev)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_context(*, multi_pod: bool = False, device=None):
    from repro_torch.dist.api import DistContext, default_rules
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    return DistContext(mesh=mesh, rules=default_rules(multi_pod),
                       multi_pod=multi_pod)


def degraded_devices(devices: np.ndarray, axis_names: Tuple[str, ...],
                     axis: str = "model", keep: Optional[int] = None
                     ) -> np.ndarray:
    """The ranks that survive when ``axis`` keeps its first ``keep``
    slices (default: half)."""
    if axis not in axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {axis_names}")
    n = devices.shape[axis_names.index(axis)]
    keep = n // 2 if keep is None else keep
    if not 1 <= keep < n:
        raise ValueError(f"keep={keep} must be in [1, {n}) for axis "
                         f"{axis!r} of size {n}")
    sl = [slice(None)] * devices.ndim
    sl[axis_names.index(axis)] = slice(0, keep)
    return devices[tuple(sl)]


def degrade_mesh(mesh: Mesh, axis: str = "model",
                 keep: Optional[int] = None) -> Mesh:
    """The surviving sub-mesh after ranks drop out of ``axis``: the first
    ``keep`` slices (default: half) along it, same axis names, so every
    spec that was legal on the old mesh re-resolves against this one
    (``dist.api.prune_specs`` handles divisibility).  Collective: every
    rank of the world calls it, the dropped ones included (they get a mesh
    whose ``coords`` are None)."""
    return Mesh(degraded_devices(mesh.devices, mesh.axis_names, axis, keep),
                mesh.axis_names, mesh.device)


def degrade_context(ctx, axis: str = "model", keep: Optional[int] = None):
    """A ``DistContext`` on the degraded mesh, same rules -- the default
    ``degrade`` hook of ``train.elastic.ResliceController``."""
    return dataclasses.replace(ctx, mesh=degrade_mesh(ctx.mesh, axis, keep))
