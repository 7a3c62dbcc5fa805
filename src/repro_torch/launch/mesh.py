"""The card's constants for the port's roofline reckoning (the counterpart
of `repro.launch.mesh`, whose TPU v5e numbers do not carry over).

Only the one card the port is measured on, for now: an NVIDIA H100 SXM
(``nvidia-smi`` names it "NVIDIA H100 80GB HBM3"; the port's chip runs
read its power limit as 700.00 W).  The numbers are NVIDIA's H100 SXM
data-sheet peaks.  `chip_smoke.bound` and `kernels.knn_ivf.autotune.
roofline_terms` divide a kernel's bytes and operations by them.

Below them: the links between cards (`link_bw`) and the mesh constructors
of the reference (`make_production_mesh`, `make_debug_mesh`) over
``torch.distributed.device_mesh``, in SPMD form: one process per rank,
on a process group the caller starts and names the backend of (``nccl``
where each rank owns a card, ``gloo`` on the CPU and for ranks that share
one card).
"""
from __future__ import annotations

#: the card the peaks below are for, as ``nvidia-smi --query-gpu=
#: name,power.limit`` prints it (`chip_smoke.py` records whether the card
#: it runs on is this one)
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: dense tensor-core peaks, FLOP/s.  f32 is the rate of f32-accurate
#: products on the tensor cores: three TF32 passes a product (big x small +
#: small x big + big x big, ssd_common.cuh) at 494.7 TFLOP/s TF32, 2.5x the
#: 67 TFLOP/s of the FMA units
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 494.7e12 / 3
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}

# ---------------------------------------------------------------------------
# links between cards (NVIDIA's data-sheet figures, not measured here): the
# counterpart of the reference's ``ICI_BW``, which does not carry over.
# `launch.knn_dryrun` divides a step's collective bytes (the ring model,
# bytes each rank sends one way, `launch.cost_analysis`) by the link of
# the group that carries them.
# ---------------------------------------------------------------------------

#: NVLink 4 on the H100 SXM, 900 GB/s a GPU in both directions together,
#: so 450 GB/s each way: a group inside one 8-GPU node (DGX H100)
NVLINK_BW = 450e9
#: a DGX H100's 400 Gb/s NDR InfiniBand link a GPU: 50 GB/s each way, for
#: a group that spans nodes (a 16-wide axis does)
NDR_BW = 50e9
#: GPUs that share one node's NVLink switch
NODE_GPUS = 8


def link_bw(group_size: int) -> float:
    """Bytes/s each way of the slowest link a ring over ``group_size``
    ranks crosses: NVLink inside one node, NDR across nodes."""
    return NVLINK_BW if group_size <= NODE_GPUS else NDR_BW


# ---------------------------------------------------------------------------
# meshes: functions, not module constants, so importing this module touches
# no process group
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes, on the process group the caller
    has started (``torch.distributed.init_process_group``; 256 or 512
    ranks, or a fake group for the dry-run): (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                    device_type=None):
    """A small (n_data, n_model) mesh over ("data", "model"), or (pod,
    n_data, n_model) over ("pod", "data", "model"), on the caller's
    process group, whose world size must be the mesh's size."""
    if pod:
        return _mesh((pod, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def _mesh(shape, axes, device_type):
    """``init_device_mesh`` over the caller's group (``device_type`` None:
    the card, as every entry point of the port), with the group over all
    its ranks made at once (`mesh_group`): a new group is a collective
    call, which every rank makes here together."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))
    mesh_group(mesh)
    return mesh


def mesh_group(mesh):
    """The process group over every rank of ``mesh``, ranked in mesh order
    (row-major over its axes): the group the sharded retrieval gathers
    over.  A mesh over the whole world in rank order is the world group;
    another is flattened (`DeviceMesh._flatten`).  Found once a mesh and
    kept on it, so later calls touch no tensor (a dry-run calls it under
    ``FakeTensorMode``)."""
    group = getattr(mesh, "_repro_flat_group", None)
    if group is None:
        import torch
        import torch.distributed as dist
        if mesh.ndim == 1:
            group = mesh.get_group()
        elif mesh.size() == dist.get_world_size() and torch.equal(
                mesh.mesh.flatten(), torch.arange(mesh.size())):
            group = dist.group.WORLD
        else:
            group = mesh._flatten().get_group()
        mesh._repro_flat_group = group
    return group


def fake_mesh(shape):
    """Start a fake process group of prod(shape) ranks (this process rank
    0; ``torch.testing``'s ``FakeStore``, nothing is sent) and return the
    mesh over it, for a dry-run under ``FakeTensorMode``: the production
    meshes for (16, 16) and (2, 16, 16), a debug mesh otherwise."""
    import math
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()        # another mesh of the sweep
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    shape = tuple(shape)
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3,
                                    device_type="cpu")
    if len(shape) == 3:
        return make_debug_mesh(shape[1], shape[2], pod=shape[0],
                               device_type="cpu")
    return make_debug_mesh(*shape, device_type="cpu")


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (0 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 0


def flat_shard_id(mesh) -> int:
    """This rank's shard of a tensor sharded over every axis of ``mesh``:
    its coordinate folded mixed-radix over the axes in mesh order (the
    reference's `_flat_shard_id`), which is its rank in `mesh_group`."""
    sid = 0
    for size, c in zip(mesh.shape, mesh.get_coordinate()):
        sid = sid * size + c
    return sid
