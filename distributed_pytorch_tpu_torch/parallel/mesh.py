"""Axis plans and the process world.

Counterpart of the reference package's `parallel/mesh.py`: `MeshPlan`,
`resolve_plan` and `rung_down` (mesh.py:41-95) are pure Python and copied
as they are, so a recipe resolves to the same axis sizes in both packages.
The reference lays its devices out as a `jax.sharding.Mesh` (`build_mesh`,
mesh.py:96-106); here the world is a `torch.distributed` process group of
one process per card, and `World` describes this process's place in it.
With a 'seq' axis (sequence parallelism, `sp` > 1), an 'expert' axis
(expert parallelism, `ep` > 1), a 'model' axis (tensor parallelism,
`tp` > 1) or a 'pipe' axis (pipeline parallelism, `pp` > 1) the ranks
form a 2-D `DeviceMesh` in the reference's axis order (`AXES`: 'data'
outermost, then 'seq', 'expert', 'model', 'pipe'): global rank =
(((data rank x sp + seq rank) x ep + expert rank) x tp + model rank) x pp
+ pipe rank, so the ranks of one seq, expert, model or pipe group sit on
adjacent cards. The mesh's
'data' group (the ranks holding the same model pieces and the same
positions of different rows) carries the parameter and optimizer
sharding's collectives, its 'seq' group (one data rank's sp ranks, which
hold different positions of the same rows) ring and Ulysses attention,
its 'expert' group (one data rank's ep ranks, which hold the same rows
and different experts) the MoE's sum over the experts, its 'model' group
(one data rank's tp pieces) the tensor-parallel ones, its 'pipe' group
(one data rank's pipeline stages) the stages' activations and gradients
(models/pipeline.py), with the 'tied' pair of its first and last stage
summing the tied embedding's gradient; the 'batch' ranks,
data x seq, hold different tokens, and the loss, the MoE's statistics
and the gradient reduce over them (under a 'pipe' axis the stage's data
group, the ranks that hold the same layers). Without a 'seq', 'expert',
'model' or 'pipe' axis the data group is the whole world. Two of these axes beside each
other are refused (ROADMAP, Queue 1 item 4). The world itself is set up
so:

* under `torch.distributed.run` the group comes from its environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`);
* NCCL on `cuda:LOCAL_RANK`, or gloo on the CPU (`platform='cpu'`);
* with no such environment a non-single recipe runs as a group of one
  rank, so every collective still runs;
* a group the caller initialized is used as it is and left standing.

`init_world` makes the group and `close_world` tears down the one it made.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from distributed_pytorch_tpu_torch import resolve_device

AXES = ("data", "seq", "expert", "model", "pipe")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved axis sizes for a recipe on a concrete device count."""

    data: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1
    pipe: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.seq * self.expert * self.model * self.pipe

    def axis_sizes(self) -> tuple[int, int, int, int, int]:
        return (self.data, self.seq, self.expert, self.model, self.pipe)


def resolve_plan(recipe: str, n_devices: int, *, tp_size: int = 1,
                 ep_size: int = 1, sp_size: int = 1, pp_size: int = 1,
                 dp_size: int = -1) -> MeshPlan:
    """Axis sizes for `recipe` over `n_devices`: the explicit axis sizes
    carve the device grid and the remaining devices land on 'data'."""
    if recipe == "single":
        return MeshPlan(1, 1, 1, 1, 1)
    tp, ep, sp = tp_size, ep_size, sp_size
    pp = pp_size
    denom = tp * ep * sp * pp
    assert n_devices % denom == 0, (
        f"recipe {recipe!r} needs tp*ep*sp*pp={denom} dividing device count "
        f"{n_devices}")
    dp = n_devices // denom if dp_size == -1 else dp_size
    assert dp * denom == n_devices, (
        f"dp_size {dp} * tp*ep*sp*pp {denom} != {n_devices} devices")
    return MeshPlan(data=dp, seq=sp, expert=ep, model=tp, pipe=pp)


def rung_down(n: int) -> int:
    """Next power-of-two data-parallel rung strictly below `n` (2->1, 3->2,
    4->2, 5->4, 8->4)."""
    assert n >= 2, f"no dp rung below {n}"
    return 1 << ((n - 1).bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world. `backend` is 'nccl', 'gloo', or
    'none' for the single recipe, which makes no group. `sp` ranks form
    the 'seq' axis, `ep` ranks the 'expert' axis, `tp` ranks the
    'model' axis and `pp` ranks the 'pipe' axis; with one of them over 1,
    `mesh` is the ("data", "seq"), ("data", "expert"), ("data", "model")
    or ("data", "pipe") `DeviceMesh` and `data_group`, `seq_group` /
    `expert_group` / `model_group` / `pipe_group` its groups of this rank
    (None where the axis is 1, and the data group None where it is the
    whole world); `tied_group` is this data rank's first and last stage
    (None on the others and without a 'pipe' axis). `batch_group` holds the ranks of different tokens,
    data x seq (None: the whole world). `seq_impl` is the sequence-parallel
    attention the run resolved once from its config (ops/ring_attention.py
    `config_impl`): 'ring', 'zigzag' or 'ulysses'; `seq_layout` follows
    from it."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    backend: str = "none"
    device: torch.device = torch.device("cpu")
    owns_group: bool = False
    tp: int = 1
    sp: int = 1
    ep: int = 1
    mesh: Any = None
    data_group: Any = None
    model_group: Any = None
    seq_group: Any = None
    expert_group: Any = None
    batch_group: Any = None
    seq_impl: str = "ring"
    pp: int = 1
    pipe_group: Any = None
    tied_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.backend != "none"

    @property
    def dp(self) -> int:
        """Ranks on the 'data' axis."""
        return self.size // (self.tp * self.ep * self.sp * self.pp)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.tp * self.ep * self.sp * self.pp)

    @property
    def seq_rank(self) -> int:
        return (self.rank // (self.tp * self.ep * self.pp)) % self.sp

    @property
    def expert_rank(self) -> int:
        return (self.rank // (self.tp * self.pp)) % self.ep

    @property
    def model_rank(self) -> int:
        return (self.rank // self.pp) % self.tp

    @property
    def pipe_rank(self) -> int:
        """This rank's pipeline stage."""
        return self.rank % self.pp

    @property
    def seq_layout(self) -> str:
        """How a row's positions are cut over 'seq': 'zigzag' under
        zig-zag attention, else 'contiguous'."""
        return "zigzag" if self.seq_impl == "zigzag" else "contiguous"

    @property
    def batch_rank(self) -> int:
        """This rank's place among the data x seq ranks."""
        return self.rank // (self.tp * self.ep * self.pp)


def torchrun_env(environ: Optional[Mapping[str, str]] = None
                 ) -> Optional[dict[str, str]]:
    """torchrun's variables when all of them are set, else None."""
    env = os.environ if environ is None else environ
    if not all(k in env for k in TORCHRUN_ENV):
        return None
    return {k: env[k] for k in TORCHRUN_ENV}


def init_world(recipe: str, platform: str = "auto",
               dp_size: int = -1, tp_size: int = 1,
               sp_size: int = 1, ep_size: int = 1,
               pp_size: int = 1) -> World:
    """The world of a training run. 'single' makes no group and refuses a
    torchrun launch of more than one process; the other recipes join (or
    make) a group of dp_size x sp_size x ep_size x tp_size x pp_size
    ranks (`dp_size` -1: the world over the others), checked as the
    reference's `resolve_plan` checks its plan, and with sp_size,
    ep_size, tp_size or pp_size > 1 lay it out as the ("data", "seq"),
    ("data", "expert"), ("data", "model") or ("data", "pipe") mesh."""
    env = torchrun_env()
    cpu = platform == "cpu"
    if recipe == "single":
        if env is not None and int(env["WORLD_SIZE"]) > 1:
            raise ValueError(
                f"parallelism='single' trains on one process; "
                f"WORLD_SIZE={env['WORLD_SIZE']} asks for a data-parallel "
                "recipe (--parallelism dp|zero1|zero2|fsdp|tp|fsdp_tp|sp|ep"
                "|pp)")
        return World(device=resolve_device("cpu" if cpu else None))
    inner = [(n, a) for n, a in (("seq", sp_size), ("expert", ep_size),
                                 ("model", tp_size), ("pipe", pp_size))
             if a > 1]
    if len(inner) > 1:
        raise NotImplementedError(
            " beside ".join(f"{n} axis of {a}" for n, a in inner)
            + ": the composition comes with ROADMAP Queue 1 item 4")
    local = int(env["LOCAL_RANK"]) if env else 0
    owns = not dist.is_initialized()
    if owns:
        backend = "gloo" if cpu else "nccl"
        if not cpu:
            resolve_device(None)
            torch.cuda.set_device(local)
        if env is not None:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(env["RANK"]),
                                    world_size=int(env["WORLD_SIZE"]))
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    else:
        backend = dist.get_backend()
        if env is None:
            local = dist.get_rank() % max(1, torch.cuda.device_count()) \
                if backend == "nccl" else 0
    rank, size = dist.get_rank(), dist.get_world_size()
    try:
        try:
            resolve_plan(recipe, size, tp_size=tp_size, sp_size=sp_size,
                         ep_size=ep_size, pp_size=pp_size, dp_size=dp_size)
        except AssertionError as e:
            raise ValueError(str(e)) from None
        if backend == "nccl":
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
        mesh = None
        groups = {}
        if inner:
            from torch.distributed.device_mesh import init_device_mesh
            name, n = inner[0]
            mesh = init_device_mesh(device.type, (size // n, n),
                                    mesh_dim_names=("data", name))
            groups = {"data": mesh.get_group("data"),
                      name: mesh.get_group(name)}
            if name == "pipe":
                groups["tied"] = groups["pipe"] if n == 2 else \
                    dist.new_subgroups_by_enumeration(
                        [[d * n, d * n + n - 1]
                         for d in range(size // n)])[0]
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    return World(rank=rank, size=size, local_rank=local, backend=backend,
                 device=device, owns_group=owns, tp=tp_size, sp=sp_size,
                 ep=ep_size, mesh=mesh, data_group=groups.get("data"),
                 model_group=groups.get("model"),
                 seq_group=groups.get("seq"),
                 expert_group=groups.get("expert"),
                 batch_group=groups.get("data") if sp_size == 1 else None,
                 pp=pp_size, pipe_group=groups.get("pipe"),
                 tied_group=groups.get("tied"))


def close_world(world: World) -> None:
    """Tear down the group `init_world` made (a caller's group stays)."""
    if world.owns_group and dist.is_initialized():
        dist.destroy_process_group()
