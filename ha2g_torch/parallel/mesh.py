"""Process layout, the rows of a global batch, and the collectives of
multi-process training (the port of ha2g_tpu/parallel/mesh.py).

The JAX package jits one global-batch program over a device mesh: the
batch splits over the mesh, batch norm takes global statistics, the
contrastive loss spans every row, and the noise draws equal one device's.
The port runs one process a device (``torchrun``, or a group the caller
made) and reproduces that program by hand:

* ``Mesh``: W = n_data x n_model ranks as ``init_device_mesh`` meshes, 1-D
  ``("data",)`` or 2-D ``("data", "model")``.  Rank r takes the rows
  [r B / W, (r + 1) B / W) of every global batch (``BatchPart``): the rows
  split over every rank, so an FSDP rank trains on its own rows as a DP
  rank does (the program, and so every number, is the same as with JAX's
  split over ``data`` alone);
* ``batch_part``: the part of the global batch this thread computes, set
  around a train step (with the mesh, ``Mesh.part``) or a synthesis part
  (without one).  It is a context variable (each thread has its own), so
  the layers deep inside a step learn it without a parameter through
  every module: batch norm all-reduces its sums, the contrastive loss
  all-gathers its rows, and every noise draw (``draw_rows``) draws the
  *global* batch's noise from the step's generator (seeded alike on every
  rank) and keeps its own rows;
* gradients: after each backward, ``reduce_grads`` averages them over
  every rank, one flat bucket an optimiser (a loss that sums over the
  batch is scaled by W first, ``as_global_sum``, so the mean over ranks is
  the global sum);
* FSDP (n_model > 1, JAX's ``hybrid_mesh`` / ``shard_state_fsdp``): every
  parameter of at least ``FSDP_MIN_SIZE`` elements with a dimension that
  n_model divides keeps 1 / n_model of itself and of both Adam moments
  between steps, split along its largest such dimension (``_fsdp_dim``,
  as ``_fsdp_spec``).  A step gathers the parameters (``unshard``), its
  gradients are reduce-scattered over ``model`` and averaged over
  ``data``, and each rank's optimiser steps its shards.  The gather and
  scatter are written here rather than taken from ``fully_shard``: the
  systems call submodules directly, run two backward passes a step, and
  read weights outside ``forward`` (the GRUs' stacked ``layer_params``,
  whose raw pointer kernel B1 takes), which FSDP2's forward hooks do not
  see.

NCCL has ``reduce_scatter_tensor`` and ``all_gather_into_tensor``; gloo
(the CPU, and two ranks sharing one card) lacks the first on CUDA
tensors, so ``reduce_scatter`` all-reduces and slices there and
``all_gather`` gathers a list: the choice goes by the group's backend.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# leaves under this many elements stay whole under FSDP (their memory is
# noise; sharding them only adds collectives), as in the JAX package
FSDP_MIN_SIZE = 2048


# ---------------------------------------------------------------------------
# process group
# ---------------------------------------------------------------------------

def rank_device(device) -> torch.device:
    """``cuda`` means ``cuda:LOCAL_RANK`` under torchrun (cuda:0 without
    it); any other device is returned as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_process_group(device) -> bool:
    """The process group of this run: one the caller initialised, else
    torchrun's (``WORLD_SIZE`` > 1 in the environment): NCCL when each rank
    has its own card, gloo on the CPU.  -> False without either (a single
    process: no group, no collective)."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def mesh_for(cfg, device) -> Optional["Mesh"]:
    """The mesh that ``cfg.dp_devices`` x ``cfg.fsdp_devices`` name over
    the process group (``dp_devices`` 0: the world size over
    ``fsdp_devices``), or None in a single process."""
    if not init_process_group(device):
        if cfg.fsdp_devices > 1 or cfg.dp_devices > 1:
            raise ValueError(
                f"dp_devices {cfg.dp_devices} x fsdp_devices "
                f"{cfg.fsdp_devices} needs as many processes: run under "
                "torchrun --nproc_per_node N")
        return None
    return Mesh(cfg.dp_devices, cfg.fsdp_devices, device)


# ---------------------------------------------------------------------------
# the part of the global batch a thread computes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchPart:
    """Part ``index`` of ``count`` equal, contiguous parts of a global
    batch; ``mesh`` the ranks that hold the other parts (None when the
    parts are threads of one process, as in sharded synthesis)."""
    index: int
    count: int
    mesh: Optional["Mesh"] = None

    def rows(self, n_local: int) -> slice:
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def of_global(self, x):
        """This part's rows of a global-batch array or tensor."""
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split into "
                             f"{self.count} equal parts")
        return x[self.rows(n // self.count)]


_PART: contextvars.ContextVar[Optional[BatchPart]] = \
    contextvars.ContextVar("ha2g_torch_batch_part", default=None)


def current_mesh() -> Optional["Mesh"]:
    part = _PART.get()
    return None if part is None else part.mesh


@contextlib.contextmanager
def batch_part(index: int, count: int, mesh: Optional["Mesh"] = None):
    """Within the block (this thread), the computation is part ``index``
    of ``count`` of a global batch."""
    token = _PART.set(BatchPart(index, count, mesh))
    try:
        yield
    finally:
        _PART.reset(token)


def draw_rows(shape, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose axis 0 is the batch: inside a
    part, ``draw`` takes the global batch's shape and the part keeps its
    rows, so the noise equals a single device's draw whatever the split
    (every part's generator must be seeded alike)."""
    shape = tuple(shape)
    part = _PART.get()
    if part is None or part.count == 1:
        return draw(shape)
    full = draw((shape[0] * part.count,) + shape[1:])
    return full[part.rows(shape[0])]


def as_global_sum(local_sum: torch.Tensor) -> torch.Tensor:
    """A loss summed over this rank's rows, times the rank count: the mean
    over ranks (what the metrics and the gradient average take) is then
    the sum over the global batch."""
    mesh = current_mesh()
    return local_sum if mesh is None else local_sum * mesh.world


def permute_rows(vids: torch.Tensor, generator: torch.Generator):
    """``vids`` permuted by one ``randperm`` over the global batch (the
    diversity term's speakers): under a mesh the ranks' rows are gathered,
    permuted alike on every rank, and each keeps its own rows."""
    mesh = current_mesh()
    full = vids if mesh is None else mesh.all_gather_rows(vids)
    perm = torch.randperm(full.shape[0], generator=generator,
                          device=generator.device)
    out = full[perm.to(full.device)]
    return out if mesh is None else _PART.get().of_global(out)


def local_rows(x):
    """This rank's rows of ``x``, which holds the global batch's rows, under
    a mesh; ``x`` itself otherwise."""
    part = _PART.get()
    return x if part is None or part.mesh is None else part.of_global(x)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather_flat(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _is_nccl(group):
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return list(out.unbind(0))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def reduce_scatter(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum ``flat`` (1-D, n equal segments) over the group; -> this rank's
    segment.  NCCL: ``reduce_scatter_tensor``; gloo (no reduce-scatter on
    CUDA tensors): all-reduce, then the segment."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    seg = flat.numel() // n
    if _is_nccl(group):
        out = torch.empty(seg, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
        return out
    flat = flat.clone()
    dist.all_reduce(flat, group=group)
    return flat[r * seg:(r + 1) * seg].clone()


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents the same way
    (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherRows(torch.autograd.Function):
    """All ranks' rows concatenated along axis 0; the backward sums every
    rank's cotangent of the global rows and keeps this rank's: each rank
    computes the same global loss, so after the gradient average over W
    ranks the parameter gradient is the global loss's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(all_gather_flat(x, group), dim=0)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        seg = reduce_scatter(grad.contiguous().reshape(-1), ctx.group)
        return seg.view((grad.shape[0] // n,) + tuple(grad.shape[1:])), None


def _fsdp_dim(shape, n_model: int, min_size: int = FSDP_MIN_SIZE):
    """The dimension a leaf is split along over ``model``: its largest
    that n_model divides (the lowest of equals), or None for a small or
    indivisible leaf (``_fsdp_spec`` of the JAX package)."""
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] >= n_model and shape[d] % n_model == 0:
            return d
    return None


def _optimizers(system) -> list:
    return [getattr(system, k) for k in ("opt", "g_opt", "d_opt")
            if hasattr(system, k)]


def _opt_params(opt) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


class Mesh:
    """The ranks of the default process group as an ``n_data`` x
    ``n_model`` mesh (``n_data`` 0: world / n_model) on ``device``."""

    def __init__(self, n_data: int = 0, n_model: int = 1, device="cpu"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group")
        self.device = rank_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.group = dist.group.WORLD
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        n_model = max(int(n_model), 1)
        n_data = int(n_data) or self.world // n_model
        if n_data * n_model != self.world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs "
                             f"{n_data * n_model} ranks, the group has "
                             f"{self.world}")
        self.n_data, self.n_model = n_data, n_model
        if n_model > 1:
            self.device_mesh = init_device_mesh(
                self.device.type, (n_data, n_model),
                mesh_dim_names=("data", "model"))
            self.data_group = self.device_mesh.get_group("data")
            self.model_group = self.device_mesh.get_group("model")
            self.model_rank = dist.get_rank(self.model_group)
        else:
            self.device_mesh = init_device_mesh(
                self.device.type, (n_data,), mesh_dim_names=("data",))
            self.data_group = self.device_mesh.get_group("data")
            self.model_group, self.model_rank = None, 0
        # FSDP: each sharded parameter's split dimension and full shape
        self._dims: dict[torch.nn.Parameter, tuple[int, torch.Size]] = {}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # ---- batch statistics ------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over every rank."""
        return _AllReduce.apply(x, self.group)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows along axis 0 (differentiable)."""
        return _GatherRows.apply(x, self.group)

    def mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x / self.world

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    @contextlib.contextmanager
    def part(self):
        """This rank's part of the global batch (see ``batch_part``)."""
        with batch_part(self.rank, self.world, self):
            yield

    # ---- placement -------------------------------------------------------
    def place(self, system) -> None:
        """Rank 0's parameters and buffers on every rank; under FSDP each
        optimiser's parameters (and Adam moments, if any) sharded.  The
        system's steps then run on this mesh (``system.mesh``)."""
        with torch.no_grad():
            tensors = [t for t in (*system.parameters(), *system.buffers())
                       if t.numel()]
            for t in tensors:
                dist.broadcast(t.data, src=0, group=self.group)
        system.mesh = self
        if self.n_model > 1:
            for opt in _optimizers(system):
                for p in _opt_params(opt):
                    d = _fsdp_dim(tuple(p.shape), self.n_model)
                    if d is not None:
                        self._dims[p] = (d, p.shape)
            self.reshard(system, state=True)

    def sharded(self, p) -> bool:
        return p in self._dims

    def _shard_of(self, t: torch.Tensor, d: int) -> torch.Tensor:
        return t.chunk(self.n_model, d)[self.model_rank].clone()

    @torch.no_grad()
    def reshard(self, system_or_opt, state: bool = False) -> None:
        """Keep this rank's shard of every full sharded parameter (and, with
        ``state``, of its Adam moments): a local slice, no collective."""
        if not self._dims:
            return
        for opt in _opt_list(system_or_opt):
            for p in _opt_params(opt):
                if p not in self._dims:
                    continue
                d, full = self._dims[p]
                if p.shape == full:
                    p.grad = None
                    p.data = self._shard_of(p.data, d)
                if state:
                    st = opt.state.get(p, {})
                    for k, v in st.items():
                        if torch.is_tensor(v) and v.shape == full:
                            st[k] = self._shard_of(v, d)

    @torch.no_grad()
    def unshard(self, system_or_opt, state: bool = False) -> None:
        """Gather every sharded parameter (and, with ``state``, its Adam
        moments) whole on every rank: one all-gather over ``model``."""
        if not self._dims:
            return
        leaves = []
        for opt in _opt_list(system_or_opt):
            for p in _opt_params(opt):
                if p not in self._dims:
                    continue
                d, full = self._dims[p]
                if p.shape != full:
                    leaves.append((p, "data", d))
                if state:
                    for k, v in opt.state.get(p, {}).items():
                        if torch.is_tensor(v) and v.dim() and v.shape != full:
                            leaves.append((opt.state[p], k, d))
        if not leaves:
            return
        shards = [getattr(o, "data") if k == "data" else o[k]
                  for o, k, _ in leaves]
        parts = all_gather_flat(torch.cat([s.reshape(-1) for s in shards]),
                                self.model_group)
        sizes = [s.numel() for s in shards]
        pieces = [part.split(sizes) for part in parts]
        for i, ((owner, key, d), s) in enumerate(zip(leaves, shards)):
            whole = torch.cat([pieces[m][i].view(s.shape)
                               for m in range(self.n_model)], dim=d)
            if key == "data":
                owner.grad = None
                owner.data = whole
            else:
                owner[key] = whole

    @contextlib.contextmanager
    def full_state(self, system, state: bool = True):
        """Within the block every parameter (and, with ``state``, every Adam
        moment) is whole on every rank (a collective: all ranks enter)."""
        self.unshard(system, state=state)
        try:
            yield
        finally:
            self.reshard(system, state=state)

    # ---- gradients -------------------------------------------------------
    @torch.no_grad()
    def reduce_grads(self, opt) -> None:
        """Average the gradients of ``opt``'s parameters over every rank,
        one flat bucket for the whole leaves; a sharded leaf's gradient is
        reduce-scattered over ``model`` and averaged over ``data``, and
        the leaf keeps its shard of the parameter and of the gradient.
        Must run inside ``part`` (``distributed_step``): the forward that
        made these gradients took global statistics only there."""
        if current_mesh() is not self:
            raise RuntimeError(
                "Mesh.reduce_grads outside Mesh.part: the step's batch norm "
                "and contrastive loss took this rank's rows alone (decorate "
                "train_step with distributed_step)")
        params = [p for p in _opt_params(opt) if p.grad is not None]
        whole = [p for p in params if p not in self._dims]
        if whole:
            flat = torch.cat([p.grad.reshape(-1) for p in whole])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world)
            for p, g in zip(whole, flat.split([p.numel() for p in whole])):
                p.grad.copy_(g.view_as(p.grad))
        split = [p for p in params if p in self._dims]
        if split:
            n = self.n_model
            chunks = [[p.grad.chunk(n, self._dims[p][0])[m] for p in split]
                      for m in range(n)]
            flat = torch.cat([c.reshape(-1) for row in chunks for c in row])
            seg = reduce_scatter(flat, self.model_group)
            if self.n_data > 1:
                dist.all_reduce(seg, group=self.data_group)
            seg.div_(self.world)
            mine = chunks[self.model_rank]
            for p, c, g in zip(split, mine, seg.split([c.numel()
                                                       for c in mine])):
                p.grad = None
                p.data = self._shard_of(p.data, self._dims[p][0])
                p.grad = g.view(c.shape).clone()
        # leaves without a gradient keep their shard all the same
        for p in _opt_params(opt):
            if p in self._dims and p.grad is None and \
                    p.shape == self._dims[p][1]:
                p.data = self._shard_of(p.data, self._dims[p][0])

    def sq_norm_of_shards(self, grads_sq: torch.Tensor) -> torch.Tensor:
        """Sum of the sharded leaves' squared gradient norms over ``model``
        (each rank holds a different shard of them)."""
        if self.model_group is None:
            return grads_sq
        grads_sq = grads_sq.clone()
        dist.all_reduce(grads_sq, group=self.model_group)
        return grads_sq

    def resident_bytes(self, system) -> int:
        """Bytes of the parameters and optimiser state this rank holds."""
        n = sum(p.numel() * p.element_size() for p in system.parameters())
        for opt in _optimizers(system):
            for st in opt.state.values():
                n += sum(v.numel() * v.element_size() for v in st.values()
                         if torch.is_tensor(v))
        return n


def _opt_list(system_or_opt) -> list:
    if isinstance(system_or_opt, torch.optim.Optimizer):
        return [system_or_opt]
    return _optimizers(system_or_opt)


# ---------------------------------------------------------------------------
# the train step under a mesh
# ---------------------------------------------------------------------------

def distributed_step(fn):
    """Decorates a system's ``train_step``: under ``self.mesh`` the step
    computes this rank's part of the global batch with every sharded
    parameter gathered, and the parameters are sharded again after it."""
    @functools.wraps(fn)
    def step(self, *args, **kwargs):
        mesh = getattr(self, "mesh", None)
        if mesh is None:
            return fn(self, *args, **kwargs)
        mesh.unshard(self)
        try:
            with mesh.part():
                return fn(self, *args, **kwargs)
        finally:
            mesh.reshard(self)
    return step


def optimizer_step(opt, loss: torch.Tensor, mesh: Optional[Mesh] = None,
                   clip: Optional[Callable[[], object]] = None,
                   regather: bool = False) -> None:
    """Zero ``opt``'s gradients, backpropagate ``loss``, average the
    gradients over ``mesh`` (when there is one), call ``clip``, step;
    with ``regather`` the sharded parameters are gathered again for the
    rest of the step (a GAN's discriminator after its own step)."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        mesh.reduce_grads(opt)
    if clip is not None:
        clip()
    opt.step()
    if mesh is not None and regather:
        mesh.unshard(opt)
