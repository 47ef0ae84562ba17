"""Production mesh construction: ``torch.distributed`` DeviceMeshes with
the JAX package's geometry and axis names.

  * single-pod:  (16, 16)    dims ("data", "model")
  * multi-pod:   (2, 16, 16) dims ("pod", "data", "model")

The geometry is the JAX package's (two TPU v5e pods of 256 chips), kept so
that every sharding spec of :mod:`repro_torch.launch.sharding` can be held
against the JAX one.  On H100 nodes of 8 GPUs the mesh lays out rank
``r = ((pod·16) + data)·16 + model`` over nodes of 8 consecutive ranks, so
the 16-wide ``model`` dim spans two nodes and ``data`` strides over 16 nodes:
both dims of the 16×16 mesh cross nodes (InfiniBand), none stays on one
node's NVLink.  ``pod`` composes with ``data`` for batch and gradient
parallelism and never shards parameters, as in the JAX package.

A mesh needs a default process group whose world size is the mesh's size:
real NCCL ranks under ``torchrun``, or the dry run's ``"fake"`` group
(:mod:`repro_torch.launch.dryrun`), in which every collective is a no-op.
Without one these functions raise.  Meshes are FUNCTIONS, not module state:
importing this module touches no device.

This is not :mod:`repro_torch.core.mesh`: that is the D4M dist layer's own
1-D group of shards, which deliberately keeps off the default group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _make(shape: Tuple[int, ...], names: Tuple[str, ...],
          device: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a default process "
            f"group of {n} ranks (torchrun with NCCL, or the dry run's fake "
            f"group); none is initialised")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                           f"ranks; the default group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return _make(shape, names, device)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *,
                   device: str = "cuda") -> DeviceMesh:
    """A small ("data", "model") mesh over the default group (tests, and
    examples on a few cards)."""
    return _make((n_data, n_model), ("data", "model"), device)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a DeviceMesh (a mapping passes through)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def batch_axes(mesh) -> tuple:
    """Mesh dims that jointly shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
