"""Device meshes over ``torch.distributed``: the port's scale-out path
(counterpart of ``pydynet_tpu/parallel/mesh.py``).

The JAX package has one controller: a single process holds every device and
GSPMD inserts the collectives from ``NamedSharding`` annotations. PyTorch
runs one process a rank, so the port's execution model is SPMD by hand:

* every rank calls the same public function with the same global
  arguments (the full ``(B, T)`` tokens, the full weights). Each rank takes
  its own share by its mesh coordinate, and every rank returns the same
  global result: tokens as the full ``(B, T)`` array, a loss as a plain
  tensor. A user's script reads as it does with the JAX package; it is
  launched with ``torchrun`` (or ``parallel._dryrun.spawn``) instead of as
  one process;
* sharded state is a ``DTensor`` (``torch.distributed.tensor``) over the
  mesh's ``DeviceMesh``, with the placements :func:`named_sharding` maps a
  PartitionSpec-like :class:`P` to: ``Shard(dim)`` on each named axis,
  ``Replicate()`` on the others;
* the collectives that GSPMD would insert are written out
  (``parallel/_comm.py``): Megatron's two all-reduces a block, the
  vocabulary all-gathers, the ring shifts of the pipeline and of ring
  attention, the all-to-all of expert parallelism, each a
  ``torch.autograd.Function`` whose backward is the transpose that JAX's AD
  gives. ``jit(mesh=)`` lets DTensor propagate them through any module.

:func:`make_mesh` builds the mesh on the card (``"cuda"``, one rank a card,
over NCCL) unless the caller asks for ``device_type="cpu"`` (gloo). Nothing
falls back: a ``"cuda"`` mesh without CUDA or without an NCCL group raises,
and a rank that fails makes the whole call raise on the others (their
collectives time out or the launcher tears the group down).
:func:`initialize_distributed` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``); with no launcher it
starts a one-rank group on a ``torch.distributed.HashStore``, which needs no
network.

Canonical axes: ``dp`` (data), ``tp`` (tensor), ``pp`` (pipeline), ``sp``
(sequence), ``ep`` (experts).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_hybrid_mesh", "initialize_distributed",
           "named_sharding", "shard", "replicate", "P", "Mesh",
           "NamedSharding"]


class P(tuple):
    """A PartitionSpec: one entry a tensor dimension, an axis name, a tuple
    of axis names, or None (not sharded)."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A named ``DeviceMesh`` with the JAX mesh's surface: ``axis_names``
    and a ``shape`` dict. ``device_mesh`` is the torch mesh the DTensors
    live on. A rank outside the mesh (a mesh over the first ranks of a
    larger group) has ``is_member`` False."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in device_mesh.mesh.shape)))
        self.device_type = device_mesh.device_type

    @property
    def is_member(self) -> bool:
        return self.device_mesh.get_coordinate() is not None

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (0 on an absent axis)."""
        if self.shape.get(name, 1) == 1:
            return 0
        return self.device_mesh.get_local_rank(name)

    def group(self, name: str):
        """The process group of this rank's line along ``name``; None on an
        absent or size-1 axis (no communication)."""
        if self.shape.get(name, 1) == 1:
            return None
        return self.device_mesh.get_group(name)

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def as_mesh(mesh) -> Mesh:
    """A :class:`Mesh` from a Mesh or a named ``DeviceMesh``."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def _default_backend() -> str:
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend: str = None, **kw):
    """Join (or start) the process group; idempotent.

    With an explicit job (``coordinator_address`` ``"host:port"``,
    ``num_processes``, ``process_id``) it joins that job over TCP; under
    ``torchrun`` it reads the launcher's environment (and sets the card of
    ``LOCAL_RANK``); with neither it starts a one-rank group on a
    ``HashStore``. ``backend`` defaults to gloo for CPU tensors and, where
    CUDA is present, NCCL for CUDA tensors. Called again in a process that
    already belongs to a group it returns, unless the caller claims another
    job than that group: then it raises ``RuntimeError``, since the group
    cannot be rejoined (silently keeping the old one would split a job into
    independent processes)."""
    if dist.is_initialized():
        if (coordinator_address is not None
                or num_processes not in (None, dist.get_world_size())
                or process_id not in (None, dist.get_rank())):
            raise RuntimeError(
                "initialize_distributed must run before the process group "
                f"is initialised: this process is already rank "
                f"{dist.get_rank()} of {dist.get_world_size()}")
        return
    backend = backend or _default_backend()
    cuda = "nccl" in backend
    env = os.environ
    if (coordinator_address is not None or num_processes not in (None, 1)
            or process_id not in (None, 0)):
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("a multi-process job needs coordinator_address,"
                             " num_processes and process_id")
        if cuda:
            kw.setdefault("device_id", torch.device(
                "cuda", int(process_id) % torch.cuda.device_count()))
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    elif "RANK" in env and "WORLD_SIZE" in env:
        if cuda:
            local = int(env.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw.setdefault("device_id", torch.device("cuda", local))
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host, no network
        if cuda:
            kw.setdefault("device_id", torch.device(
                "cuda", torch.cuda.current_device()))
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


def _check_backend(device_type: str):
    """No fallback: a "cuda" mesh needs CUDA and an NCCL group, a "cpu" mesh
    a gloo one."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device_type {device_type!r}: use "
                         "'cuda' or 'cpu'")
    backend = str(dist.get_backend())
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh was asked for but no CUDA GPU "
                               "is available")
        if "nccl" not in backend:
            raise RuntimeError(f"a 'cuda' mesh needs an NCCL process group; "
                               f"this one's backend is {backend!r}")
    elif "gloo" not in backend:
        raise RuntimeError(f"a 'cpu' mesh needs a gloo process group; this "
                           f"one's backend is {backend!r}")


def make_mesh(axes: dict, devices=None, device_type: str = None) -> Mesh:
    """A mesh from ``{'dp': 2, 'tp': 4}``-style axis sizes over the ranks
    ``devices`` (default: every rank of the group, which is started if
    there is none; the first ``prod(sizes)`` of them are used, in order).
    ``device_type`` is ``"cuda"`` (the default, one rank a card) or
    ``"cpu"``. Every rank of the group must call it: a mesh over fewer
    ranks makes the others non-members (``Mesh.is_member``)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = device_type or "cuda"
    if not dist.is_initialized():
        initialize_distributed()
    _check_backend(device_type)
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    sizes = [int(s) for s in axes.values()]
    n = math.prod(sizes)
    if n > len(ranks):
        raise ValueError(
            f"mesh needs {n} devices, only {len(ranks)} available")
    names = tuple(axes.keys())
    if devices is None and n == len(ranks):
        dm = init_device_mesh(device_type, tuple(sizes),
                              mesh_dim_names=names)
    else:
        dm = DeviceMesh(device_type,
                        torch.tensor(ranks[:n]).reshape(sizes),
                        mesh_dim_names=names)
    return Mesh(dm)


def make_hybrid_mesh(ici_axes: dict, dcn_axes: dict, devices=None,
                     device_type: str = None) -> Mesh:
    """A mesh over several hosts with the split made explicit: ``ici_axes``
    partition within a host (its cards' NVLink: put tp/sp here),
    ``dcn_axes`` across hosts (the network: put dp/pp here). The dcn axes
    are major: ranks are numbered host-major (``torchrun``'s order), so a
    collective along an ici axis stays within one host.

    On one host every dcn axis must be 1 and the helper is
    :func:`make_mesh` over the local ranks."""
    names = tuple(dcn_axes.keys()) + tuple(ici_axes.keys())
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate axis names: {names}")
    if not dist.is_initialized():
        initialize_distributed()
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(1, world // local)
    if hosts == 1:
        for name, size in dcn_axes.items():
            if size != 1:
                raise ValueError(
                    f"dcn axis {name!r}={size} needs a multi-process job "
                    "over several hosts (this job has one host)")
    elif (math.prod(ici_axes.values()) != local
          or math.prod(dcn_axes.values()) != hosts):
        raise ValueError(
            f"ici axes {ici_axes} must cover the {local} ranks of a host and "
            f"dcn axes {dcn_axes} the {hosts} hosts")
    return make_mesh({**dcn_axes, **ici_axes}, devices, device_type)


class NamedSharding:
    """A mesh and a :class:`P`, with the DTensor ``placements`` they mean:
    ``Shard(d)`` on each mesh axis that the spec names at dimension ``d``,
    ``Replicate()`` on the others."""

    def __init__(self, mesh, spec: P):
        self.mesh = as_mesh(mesh)
        self.spec = spec if isinstance(spec, P) else P(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dim = next((d for d, s in enumerate(self.spec)
                        if s == axis or (isinstance(s, tuple) and axis in s)),
                       None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """This sharding's local block of a global ``shape``."""
        shape = list(shape)
        for d, s in enumerate(self.spec):
            for axis in (s if isinstance(s, tuple) else (s,)):
                if axis is not None:
                    shape[d] //= self.mesh.axis_size(axis)
        return tuple(shape)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard(x, mesh, *spec):
    """``x`` (a global array, the same on every rank) placed on the mesh by
    the PartitionSpec: a DTensor whose local block each rank cuts from its
    own copy, with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    sh = named_sharding(mesh, *spec)
    if isinstance(x, DTensor):
        return x.redistribute(sh.mesh.device_mesh, sh.placements)
    return distribute_tensor(_tensor(x, sh.mesh.device), sh.mesh.device_mesh,
                             sh.placements, src_data_rank=None)


def replicate(x, mesh):
    return shard(x, mesh)


def local(x):
    """A DTensor's local block; anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def full(x):
    """A DTensor gathered to its global value (a collective: every rank of
    its mesh must call it); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def mesh_of(tree):
    """The :class:`Mesh` of the first DTensor among a dict's values, else
    None."""
    from torch.distributed.tensor import DTensor

    for v in tree.values():
        if isinstance(v, DTensor):
            return Mesh(v.device_mesh)
    return None


def from_local(x, sharding: NamedSharding, shape=None):
    """A DTensor over ``sharding`` from this rank's block ``x``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, sharding.mesh.device_mesh,
                              sharding.placements, run_check=False,
                              shape=shape, stride=None if shape is None else
                              torch.empty(shape, device="meta").stride())
