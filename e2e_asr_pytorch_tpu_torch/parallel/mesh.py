"""The data x model mesh of ranks (port of
e2e_asr_pytorch_tpu/parallel/mesh.py).

The JAX package runs one process over every visible device and lets GSPMD
place the collectives. The port runs one process per device with
``torch.distributed`` (NCCL on the card, gloo with ``--cpu``): rank
``r = d * n_model + m`` sits at row d of the 'data' axis and column m of
the 'model' axis, on ``cuda:r`` (the node's local rank under ``torchrun``).
The semantics kept are the JAX solver's:

  * the batch is split over 'data': each rank holds contiguous rows of the
    global batch (mesh-padding rows carry weight 0), and each loss divides
    this rank's weighted sum by the weight summed over 'data'
    (``global_sum``), so the ranks' losses and gradients add up to the
    one-device ones;
  * ``param_shardings``: a 2-D leaf whose last (output) dim is at least
    ``min_dim`` and divisible by n_model shards that dim over 'model',
    everything else replicates. Under ``--n-model k`` each rank stores its
    1/k column slice of such a leaf and of its optimizer state
    (``place_params`` / ``place_opt_state``);
  * the hand kernels take whole matrices, so a sharded leaf is all-gathered
    over 'model' before use (``gather``), as GSPMD gathers around a Pallas
    call; its gradient, the same on every rank of a 'model' group, is cut
    to this rank's slice and summed over 'data' (``reduce_grads``: the
    reduce-scatter of the summed gradient onto the shards).

A failed init or collective raises: there is no fallback to one rank or to
the CPU. One process holds one rank, so the current mesh is module state
(``current()``), as ``torch.distributed``'s default group is.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
MIN_DIM = 512
SHARDED = (None, MODEL_AXIS)     # a leaf's spec: its last dim over 'model'
REPLICATED = ()

_CURRENT: Optional["Mesh"] = None


def current() -> Optional["Mesh"]:
    """This process's mesh, or None in a single-process run."""
    return _CURRENT


def visible_devices(cpu: bool) -> int:
    """The devices a mesh may use: the CUDA cards, or with ``--cpu`` the
    CPU cores this process may run on (one gloo rank a core)."""
    if cpu:
        return len(os.sched_getaffinity(0))
    return torch.cuda.device_count()


def mesh_shape(n_devices: Optional[int], n_model: int, cpu: bool):
    """(n_data, n_model) for ``--n-devices`` / ``--n-model``: every visible
    device when ``n_devices`` is None, as in JAX. Raises ValueError for a
    mesh larger than the visible devices or an n_model that does not
    divide the device count."""
    visible = visible_devices(cpu)
    n = visible if n_devices is None else int(n_devices)
    n_model = max(1, int(n_model))
    if n < 1:
        raise ValueError("--n-devices must be at least 1, got {}".format(n))
    if n > visible:
        raise ValueError(
            "mesh larger than device count: --n-devices {} but {} {} "
            "visible (one rank a device)".format(
                n, visible, "CPU cores" if cpu else "CUDA devices"))
    if n % n_model:
        raise ValueError("--n-model must divide the device count: "
                         "--n-model {}, {} devices".format(n_model, n))
    return n // n_model, n_model


def param_shardings(tree, n_model: int, min_dim: int = MIN_DIM):
    """The tree's specs: ``SHARDED`` for a 2-D leaf whose last dim is at
    least ``min_dim`` and divisible by ``n_model`` > 1, else
    ``REPLICATED`` (the JAX rule, on full-size leaves)."""
    def rule(x):
        if (n_model > 1 and x.dim() == 2 and x.shape[-1] >= min_dim
                and x.shape[-1] % n_model == 0):
            return SHARDED
        return REPLICATED
    return tree_map(rule, tree)


def _is_sharded(spec) -> bool:
    return spec == SHARDED


class Mesh:
    """One rank's view of the n_data x n_model grid: its coordinates, its
    device and the process groups of its 'data' column and 'model' row."""

    def __init__(self, n_data: int, n_model: int, rank: int,
                 device: torch.device, data_group, model_group):
        self.n_data = n_data
        self.n_model = n_model
        self.rank = rank
        self.device = device
        self.data_group = data_group
        self.model_group = model_group

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def dp_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def mp_rank(self) -> int:
        return self.rank % self.n_model

    # ------------------------------------------------------------ data axis
    def _sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the 'data' axis, in place."""
        dist.all_reduce(x, group=self.data_group)
        return x

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A loss denominator (a weight or count, no gradient) summed over
        the data ranks, in ``x``'s dtype: the ranks' partial sums add in
        f32 and the total is rounded once, so one rank's sum is ``x``
        itself and the quotient keeps the loss's dtype, as the JAX
        package's global ``jnp.sum`` does (a bf16 numerator over an f32
        denominator would give an f32 loss and other gradient bits)."""
        return self._sum_data(x.detach().float().clone()).to(x.dtype)

    def rows(self, n_rows: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n_rows``
        (a multiple of n_data)."""
        if n_rows % self.n_data:
            raise ValueError("a global batch of {} rows does not split over "
                             "{} data ranks".format(n_rows, self.n_data))
        per = n_rows // self.n_data
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' row blocks of ``x`` (equal shapes), in rank
        order: the global batch's rows."""
        parts = [torch.empty_like(x) for _ in range(self.n_data)]
        dist.all_gather(parts, x.contiguous(), group=self.data_group)
        return torch.cat(parts, dim=0)

    # ----------------------------------------------------------- model axis
    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's column slice of a full leaf's last dim."""
        w = x.shape[-1] // self.n_model
        return x[..., self.mp_rank * w:(self.mp_rank + 1) * w].contiguous()

    def _gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """The 'model' row's slices of a leaf joined in rank order (bits
        moved as they are: a bf16 leaf travels as its bytes)."""
        bf16 = x.dtype == torch.bfloat16
        bits = x.contiguous().view(torch.uint8) if bf16 else x.contiguous()
        parts = [torch.empty_like(bits) for _ in range(self.n_model)]
        dist.all_gather(parts, bits, group=self.model_group)
        out = torch.cat(parts, dim=-1)
        return out.view(torch.bfloat16) if bf16 else out

    def place(self, tree, specs):
        """The tree with each sharded leaf cut to this rank's slice."""
        return tree_map(lambda x, s: self.shard(x) if _is_sharded(s) else x,
                        tree, specs)

    def gather(self, tree, specs):
        """The full tree: every sharded leaf all-gathered over 'model'
        (the tree itself when nothing is sharded)."""
        if not any(_is_sharded(s) for s in tree_leaves_specs(specs)):
            return tree
        return tree_map(lambda x, s: self._gather_model(x)
                        if _is_sharded(s) else x, tree, specs)

    def reduce_grads(self, grads, specs):
        """Full gradients (this rank's rows) -> this rank's leaves of the
        global gradient: a sharded leaf cut to its slice, then every leaf
        summed over 'data' (one flat buffer a dtype)."""
        local = tree_map(lambda g, s: self.shard(g) if _is_sharded(s) else g,
                         grads, specs)
        leaves = tree_leaves(local)
        by_dtype = {}
        for i, g in enumerate(leaves):
            by_dtype.setdefault(g.dtype, []).append(i)
        out = list(leaves)
        for idx in by_dtype.values():
            flat = self._sum_data(torch.cat([leaves[i].reshape(-1)
                                             for i in idx]))
            for i, part in zip(idx, torch.split(
                    flat, [leaves[i].numel() for i in idx])):
                out[i] = part.view(leaves[i].shape)
        it = iter(out)
        return tree_map(lambda _: next(it), local)

    def grad_norm(self, grads, specs) -> torch.Tensor:
        """The global gradient's norm from this rank's leaves: the sharded
        leaves' squares summed over 'model', the replicated ones once."""
        rep, shd = [], []
        for g, s in zip(tree_leaves(grads), tree_leaves_specs(specs)):
            (shd if _is_sharded(s) else rep).append(
                torch.sum(torch.square(g.float())))
        zero = torch.zeros((), device=self.device)
        sq = sum(rep, zero)
        if shd:
            part = sum(shd, zero).clone()
            dist.all_reduce(part, group=self.model_group)
            sq = sq + part
        return torch.sqrt(sq)

    def barrier(self):
        dist.barrier()


def tree_leaves_specs(specs) -> List:
    """The specs of a tree in leaf order (a spec is a tuple, so the tree's
    own ``tree_leaves`` would descend into it)."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in tree_leaves_specs(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in tree_leaves_specs(v)]
    return [specs]


def place_params(params, mesh: Mesh, min_dim: int = MIN_DIM):
    """(this rank's params, their specs) from the full tree."""
    specs = param_shardings(params, mesh.n_model, min_dim)
    return mesh.place(params, specs), specs


def place_opt_state(opt_state, mesh: Mesh, min_dim: int = MIN_DIM):
    """(this rank's optimizer state, its specs): the accumulators mirror
    the parameters' shapes, so the same shape rule shards them with their
    leaves; the update count replicates. No rank holds a full replica of a
    sharded leaf's state."""
    specs = param_shardings(opt_state, mesh.n_model, min_dim)
    return mesh.place(opt_state, specs), specs


def init(n_data: int, n_model: int, rank: int, init_method: str,
         cpu: bool, local_rank: Optional[int] = None) -> Mesh:
    """Join the process group (gloo with ``cpu``, else NCCL on
    ``cuda:local_rank``) and build this rank's 'data' and 'model' groups.
    Every rank calls this with the same shape; it becomes ``current()``."""
    global _CURRENT
    world = n_data * n_model
    if cpu:
        device = torch.device("cpu")
        # the ranks share the cores: one rank's threads to its share
        torch.set_num_threads(max(1, visible_devices(True) // world))
    else:
        device = torch.device("cuda", rank if local_rank is None
                              else local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=init_method, world_size=world,
                            rank=rank, **({} if cpu else {"device_id": device}))
    data_group = model_group = None
    # every rank creates every group, in the same order
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    _CURRENT = Mesh(n_data, n_model, rank, device, data_group, model_group)
    return _CURRENT


def shutdown(failed: bool = False):
    """Leave the process group: after a barrier, so no rank exits while
    another still waits on it; without one when this rank ``failed`` (the
    others will never reach it: the launch fails instead)."""
    global _CURRENT
    if _CURRENT is not None:
        if not failed:
            dist.barrier()
        dist.destroy_process_group()
        _CURRENT = None


def _run_rank(fn: Callable, args):
    try:
        out = fn(*args)
    except BaseException:
        shutdown(failed=True)
        raise
    shutdown()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n_data: int, n_model: int, init_method: str,
               cpu: bool, fn: Callable, args):
    init(n_data, n_model, rank, init_method, cpu)
    _run_rank(fn, args)


def launch(n_data: int, n_model: int, cpu: bool, fn: Callable, *args):
    """Run ``fn(*args)`` on every rank of an n_data x n_model mesh.

    Under ``torchrun`` (RANK / WORLD_SIZE / MASTER_ADDR set) this process
    is one rank and joins the group from the environment. Otherwise a
    one-rank mesh runs in this process (and ``fn``'s result is returned),
    and a larger one starts its ranks with ``torch.multiprocessing`` on a
    free localhost port; a rank that fails fails the launch."""
    world = n_data * n_model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError("WORLD_SIZE={} but the mesh is {} x {}".format(
                os.environ["WORLD_SIZE"], n_data, n_model))
        init(n_data, n_model, int(os.environ["RANK"]), "env://", cpu,
             int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        return _run_rank(fn, args)
    init_method = "tcp://localhost:{}".format(free_port())
    if world == 1:
        init(1, 1, 0, init_method, cpu)
        return _run_rank(fn, args)
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(n_data, n_model, init_method, cpu, fn, args),
             nprocs=world, join=True)
    return None
