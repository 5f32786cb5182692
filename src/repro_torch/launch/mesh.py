"""Production mesh construction (NVIDIA H100, HGX nodes of 8 cards).

Counterpart of ``repro.launch.mesh``.  The device counts are the
reference's, 256 and 512; ``"model"`` spans the 8 cards of one HGX H100
node, the NVLink domain where tensor parallelism belongs, and ``"data"``
crosses nodes:

* single pod: 32 x 8 = 256 cards, axes ("data", "model");
* two pods:   2 x 32 x 8 = 512 cards, axes ("pod", "data", "model"), the
  "pod" axis pure data parallelism.

The meshes are built by functions (never module-level constants), so
importing this module touches no process group.  ``MeshShape`` is the
process-group-free form that the partitioner and the dry run read: axis
names and sizes only, with the interface of the reference tests' duck-typed
mesh (``shape`` a dict, ``axis_names``, ``size``).
"""
from __future__ import annotations

import math

PRODUCTION = {False: {"data": 32, "model": 8}, True: {"pod": 2, "data": 32, "model": 8}}


class MeshShape:
    """Axis names and sizes, no devices: ``shape`` {name: size} in mesh
    order, ``axis_names`` and ``size``."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return "x".join(str(n) for n in self.shape.values())


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape``, any mesh
    whose ``shape`` is such a dict, or such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_label(mesh) -> str:
    """"32x8", "2x32x8": the sizes in mesh order."""
    return "x".join(str(n) for n in axis_sizes(mesh).values())


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    return MeshShape(PRODUCTION[multi_pod])


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` of cards over the default process group,
    which must have 256 (512 with `multi_pod`) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes = PRODUCTION[multi_pod]
    return init_device_mesh("cuda", tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """A small ("data", "model") mesh for tests and single-node runs; the
    default process group must have n_data * n_model ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (n_data, n_model), mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))
