"""Two meshes with ``data`` and ``model`` axes: one of devices, one of processes.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX drives every
device of a host from one process (one ``jax.sharding.Mesh``) and several
hosts from several processes; PyTorch's idiom splits the two regimes:

- **A device mesh** (``build_mesh``), for serving: one process, a ``(dp,
  tp)`` grid of ``torch.device``. The row-sharded catalog, IVF's build and
  the text encoder put one shard on each device of the ``data`` axis. A
  test may put several shards on ``cpu``, or on one GPU.
- **A process mesh** (``ProcessMesh``), for training: one process per GPU
  (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), global rank
  ``data_rank * tp + model_rank`` as JAX lays out a ``(dp, tp)`` mesh, a
  data group (the ranks of one model rank) and a model group (the ranks of
  one data rank), each on the device's backend and again on gloo for host
  tensors (checkpoint gathers, the resume broadcast).

On CUDA tensors the port calls only ``all_reduce`` and ``broadcast``, the
two collectives that both NCCL and gloo take there; ``all_gather_rows``
builds a gather from an all-reduce.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data_parallel=None`` means "every device (or
    process) the model axis leaves"."""

    data_parallel: int | None = None
    model_parallel: int = 1


def _shape(config: MeshConfig, n: int, what: str) -> tuple[int, int]:
    """``(dp, tp)`` of ``config`` over ``n`` ``what`` (devices or
    processes); raises as the JAX package's ``build_mesh`` does when it does
    not fit."""
    tp = max(1, config.model_parallel)
    if n % tp != 0:
        raise ValueError(f"model_parallel={tp} does not divide the {n} {what}")
    dp = config.data_parallel if config.data_parallel is not None else n // tp
    if dp < 1 or dp * tp > n:
        raise ValueError(f"mesh shape ({dp}, {tp}) needs {dp * tp} {what}, have {n}")
    return dp, tp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, tp)`` grid of devices in one process: ``devices[d][m]``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each data shard (model rank 0 of each row)."""
        return [row[0] for row in self.devices]


def build_mesh(
    config: MeshConfig | None = None, devices: list[str | torch.device] | None = None
) -> Mesh:
    """The device mesh over ``devices`` (default: every local GPU, in index
    order; raises where there is none). ``devices`` may repeat a device: a
    test's shards on ``cpu``, or two shards on one GPU."""
    config = config or MeshConfig()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: no CUDA device; pass devices= to build one elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp, tp = _shape(config, len(devices), "devices")
    return Mesh(tuple(tuple(devices[d * tp + m] for m in range(tp)) for d in range(dp)))


def data_devices(mesh: Mesh | None) -> list[torch.device] | None:
    """The data shards' devices of ``mesh``; None for no mesh or one shard.
    Raises on anything that is not a ``parallel.Mesh``."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.Mesh (build_mesh), got {type(mesh).__name__}")
    return mesh.data_devices if mesh.shape[DATA_AXIS] > 1 else None


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round ``n`` up to a multiple (for even sharding of batches/catalogs)."""
    return -(-n // multiple) * multiple


def init_distributed(device: str | torch.device = "cuda") -> None:
    """Join the process group torchrun describes, where it describes one.

    Does nothing when ``WORLD_SIZE`` is unset or 1, or when a process group
    exists already (the caller's is used). Otherwise initializes it from
    torchrun's environment: ``gloo`` for the CPU; for a CUDA ``device``,
    ``nccl`` with ``cuda:LOCAL_RANK`` where each of the host's
    ``LOCAL_WORLD_SIZE`` processes has a GPU of its own, and ``gloo`` with
    ``cuda:LOCAL_RANK`` modulo the GPU count where more processes than GPUs
    share the host (NCCL refuses two ranks on one GPU). Raises when
    initialization fails: the operator asked for N processes, and N
    processes each training alone would write one output tree N times.
    """
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = "gloo"
    try:
        if cuda:
            local, gpus = int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count()
            if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= gpus:
                backend = "nccl"
            torch.cuda.set_device(local % gpus)
        dist.init_process_group(backend, init_method="env://")
    except Exception as exc:
        raise RuntimeError(
            "WORLD_SIZE > 1 but the process group did not initialize (check MASTER_ADDR, "
            "MASTER_PORT, RANK and LOCAL_RANK, or launch with torchrun)"
        ) from exc
    logger.info(
        "process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
        dist.get_backend(),
    )


def host_rendezvous(
    host: str = "127.0.0.1", port: int = 0
) -> tuple[dist.TCPStore, dict[str, str]]:
    """Host the rendezvous store of a group of processes this process
    starts, as torchrun's agent does: a ``TCPStore`` bound to ``port`` (0:
    one the OS picks) and held for as long as the store lives. Returns the store
    (keep it until the workers exit) and what each worker's environment
    adds (``MASTER_ADDR``, ``MASTER_PORT``, ``TORCHELASTIC_USE_AGENT_STORE``),
    so that every rank's ``init_distributed`` joins it as a client.

    A port found free and then released (bind to port 0, close, pass the
    number on) stays free only until some other socket on the host takes
    it: the seconds the workers take to import and reach their rendezvous
    are enough for a busy host's connections to be given it, and then
    rank 0 cannot host the store and the group never forms."""
    store = dist.TCPStore(host, port, is_master=True, wait_for_workers=False)
    env = {"MASTER_ADDR": host, "MASTER_PORT": str(store.port),
           "TORCHELASTIC_USE_AGENT_STORE": "True"}
    return store, env


class ProcessMesh:
    """This process's place in a ``(dp, tp)`` mesh of training processes.

    With one process (no process group) every group is None and every
    collective helper below is the identity. Creating it with several
    processes is itself collective: every rank makes every group, in one
    order, as ``dist.new_group`` requires.
    """

    def __init__(self, config: MeshConfig):
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.dp, self.tp = _shape(config, self.world, "processes")
        if self.dp * self.tp != self.world:
            raise ValueError(
                f"mesh shape ({self.dp}, {self.tp}) needs {self.dp * self.tp} processes, "
                f"this run has {self.world} (launch one per device: torchrun --nproc-per-node)"
            )
        self.data_rank, self.model_rank = divmod(self.rank, self.tp)
        self.data_group = self.model_group = self.host_group = self.host_model_group = None
        if self.world == 1:
            return
        # gloo for host tensors; on a gloo run it is the same kind of group.
        self.host_group = dist.new_group(backend="gloo")
        for d in range(self.dp if self.tp > 1 else 0):
            ranks = [d * self.tp + m for m in range(self.tp)]
            group, host = dist.new_group(ranks), dist.new_group(ranks, backend="gloo")
            if d == self.data_rank:
                self.model_group, self.host_model_group = group, host
        for m in range(self.tp if self.dp > 1 else 0):
            group = dist.new_group([d * self.tp + m for d in range(self.dp)])
            if m == self.model_rank:
                self.data_group = group

    @property
    def is_main(self) -> bool:
        """Data-and-model rank 0: the one process that writes files."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.host_group is not None:
            dist.barrier(group=self.host_group)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled over the host group)."""
        if self.host_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``[B, ...]`` blocks stacked in rank order, ``[world * B,
    ...]``, by one all-reduce of a zeroed buffer that holds this rank's block
    at its place (``all_reduce`` is what NCCL and gloo both take on CUDA)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    b = x.shape[0]
    buf = x.new_zeros((world * b, *x.shape[1:]))
    buf[rank * b : (rank + 1) * b] = x
    dist.all_reduce(buf, group=group)
    return buf


def gather_host(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' host tensors concatenated along ``dim`` in rank order
    (gloo's all_gather on the CPU)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
