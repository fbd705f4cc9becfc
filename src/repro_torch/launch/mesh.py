"""Production mesh builders.

Port of ``repro/launch/mesh.py`` onto
:func:`torch.distributed.device_mesh.init_device_mesh`.  The builders are
FUNCTIONS (not module-level constants), so importing this module touches
no device and no process group.  The caller owns
``torch.distributed.init_process_group``: its world size must equal the
mesh's size.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device) -> str:
    return torch.device("cuda" if device is None else device).type


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """Single-pod (16, 16) = 256 ranks, or 2-pod (2, 16, 16) = 512 ranks,
    on the card unless ``device="cpu"``.

    Axes: "data" carries DP/FSDP, "model" carries TP/SP/EP; "pod" (multi-pod
    only) is pure data parallelism across pods with gradient all-reduce.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device=None) -> DeviceMesh:
    """Small ("data", "model") mesh over ``data * model`` ranks, used by
    tests and the sequence-parallel decode."""
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))
