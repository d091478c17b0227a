"""Device meshes over ``torch.distributed``.

A port of the JAX package's ``launch/mesh.py``.  A mesh shape is an ordered
mapping of axis name to size (``{"data": 8, "model": 8}``, or
``{"pod": 2, "data": 4, "model": 8}`` with the slow axis first).
``make_production_mesh`` gives the reference's production shapes, which the
dry run lays out on a fake process group; a real H100 deployment's shape is
its node count times its cards a node, passed to ``make_mesh``, whose
process group must already be initialised with ``prod(shape)`` ranks.
"""
from __future__ import annotations

from typing import Dict

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.device import Device, require_device


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh shape: 16 x 16 = 256 ("data",
    "model"); with ``multi_pod``, 2 x 16 x 16 = 512 ("pod", "data",
    "model"), the "pod" axis the slow one, across which data parallelism
    and the relay and compressed collectives run."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh(shape: Dict[str, int], device_type: Device = "cuda"
              ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape``'s sizes named by its keys, in order
    (the major axis first, as JAX orders a mesh)."""
    dev = require_device(device_type)
    return init_device_mesh(dev.type, tuple(int(n) for n in shape.values()),
                            mesh_dim_names=tuple(shape))


def make_test_mesh(n_devices: int = 1, device_type: Device = "cuda"
                   ) -> DeviceMesh:
    """The (1, n) ("data", "model") mesh of the reference's tests."""
    return make_mesh({"data": 1, "model": n_devices}, device_type)
