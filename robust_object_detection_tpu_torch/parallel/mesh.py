"""The (data, model) mesh over ``torch.distributed`` (counterpart of
robust_object_detection_tpu/parallel/mesh.py).

In the reference one process drives every device of a mesh and XLA inserts
the collectives; in the port a device is a process, so the mesh is a
factoring of the process group. Rank r sits at (data index r // model,
model index r % model), the reference's ``devices.reshape(data, model)``.
Its data group holds the ranks with its model index (they see different
rows of the global batch and sum their gradients); its model group holds
the ranks with its data index (they see the same rows and split the
RT-DETR decoder's layers, Megatron style). With no process group the mesh
is 1 x 1 and every collective here is a no-op.

A train step runs under :func:`data_parallel`: while it is active the
train-mode BatchNorms take their statistics over the global batch
(:func:`sync_moments`, one all-reduce of the per-channel moments, inside
the autograd graph) and the loss normalisers sum over it
(:func:`global_sum`). The global loss is the sum of the ranks' losses, so
gradients are summed over the data group (:func:`all_reduce_grads`), not
averaged. Under the decoder split, what the reference holds as one
replicated array (a replicated leaf's gradient, a matching) is model index
0's value on every rank of the model group (:func:`broadcast_over_model`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass
class MeshContext:
    """This process's place in the mesh and its two process groups (None
    with no process group)."""
    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def grouped(self) -> bool:
        """A process group backs this mesh (collectives run, even on a
        1 x 1 mesh of one process)."""
        return self.data_group is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(cfg: MeshConfig = MeshConfig()) -> MeshContext:
    """The mesh `cfg` factors the process group into (the reference's
    ``MeshConfig.axis_sizes``: data -1 takes the processes the model axis
    leaves; the product must equal the world size). Every rank calls this
    in the same order: it creates every data and model group."""
    if not _grouped():
        cfg.axis_sizes(1)
        return MeshContext()
    world = dist.get_world_size()
    if cfg.data > 0 and cfg.data * max(1, cfg.model) > world:
        raise ValueError(f"mesh needs {cfg.data * max(1, cfg.model)} "
                         f"devices, have {world}")
    data, model = cfg.axis_sizes(world)
    rank = dist.get_rank()
    ctx = MeshContext(data, model, rank)
    for m in range(model):                  # every rank makes every group
        g = dist.new_group([d * model + m for d in range(data)])
        if m == ctx.model_index:
            ctx.data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == ctx.data_index:
            ctx.model_group = g
    return ctx


# ── The active data-parallel context ─────────────────────────────────────

_ACTIVE: Optional[MeshContext] = None


@contextlib.contextmanager
def data_parallel(ctx: Optional[MeshContext]) -> Iterator[None]:
    """Within: train-mode BatchNorm statistics and loss normalisers span
    ctx's data group (nothing changes for None or a mesh without a
    process group)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (ctx if ctx is not None and ctx.grouped
                              else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[MeshContext]:
    """The data-parallel context a step runs under, or None."""
    return _ACTIVE


class _AllReduceMean(torch.autograd.Function):
    """Mean over a group in the forward; the backward is the same mean of
    the cotangents (each rank's loss reads the one mean)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def sync_moments(mean: torch.Tensor, meansq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel E[y] and E[y^2] of the local rows -> those of the global
    batch (every rank holds as many rows), in one all-reduce of the
    stacked pair, differentiable. Without an active context: unchanged."""
    ctx = _ACTIVE
    if ctx is None:
        return mean, meansq
    both = _AllReduceMean.apply(torch.stack([mean, meansq]),
                                ctx.data_group, ctx.n_data)
    return both[0], both[1]


def mean_over_data(t: torch.Tensor) -> torch.Tensor:
    """t averaged over the active data group, in place (no autograd); the
    hand kernels' batch sums and their cotangents go through this."""
    ctx = _ACTIVE
    if ctx is not None:
        dist.all_reduce(t, group=ctx.data_group)
        t.div_(ctx.n_data)
    return t


_SYNC_FN = None


def kernel_sync(*scratch: torch.Tensor):
    """(sync, keep) for a train-mode K2 / K4 entry point: sync is the
    pointer of a C callback (rodt::SyncFn, csrc/conv_tile.cuh) that
    averages the n floats at a device address inside one of the `scratch`
    tensors over the active data group (:func:`mean_over_data`, on the
    caller's stream), keep the object to hold until the launch returns.
    (None, None) when no data-parallel step is active: the kernels then
    take their statistics over this rank's rows alone."""
    if _ACTIVE is None:
        return None, None
    import ctypes
    global _SYNC_FN
    if _SYNC_FN is None:
        _SYNC_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int)

    def call(ptr, n):
        try:
            for t in scratch:
                flat = t.view(-1)
                off, rem = divmod(ptr - flat.data_ptr(), flat.element_size())
                if rem == 0 and 0 <= off <= flat.numel() - n:
                    mean_over_data(flat[off:off + n])
                    return 0
            print(f"kernel_sync: {ptr:#x} lies in no scratch tensor",
                  file=sys.stderr)
        except Exception as e:      # a callback must not raise into C
            print(f"kernel_sync: {e!r}", file=sys.stderr)
        return 1
    keep = _SYNC_FN(call)
    return ctypes.cast(keep, ctypes.c_void_p), keep


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """A count or sum over the local rows -> over the global batch (a loss
    normaliser; no gradient flows through it)."""
    ctx = _ACTIVE
    if ctx is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=ctx.data_group)
    return t


def all_reduce_grads(params, ctx: Optional[MeshContext]) -> None:
    """Sum every gradient over ctx's data group, in one flat buffer per
    dtype (the loss is the sum of the ranks' losses)."""
    if ctx is None or not ctx.grouped:
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=ctx.data_group)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def broadcast_over_model(tensors, ctx: Optional[MeshContext]) -> None:
    """Model index 0's values of `tensors` on every rank of ctx's model
    group, in place, in one flat buffer per dtype (bool through uint8):
    a leaf the reference holds as one replicated array has one value. A
    no-op on a model axis of 1 or without a process group."""
    if ctx is None or ctx.n_model == 1:
        return
    src = ctx.data_index * ctx.n_model      # global rank of model index 0
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in group])
        if dtype == torch.bool:
            flat = flat.to(torch.uint8)
        dist.broadcast(flat, src=src, group=ctx.model_group)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def sum_over_data(metrics: Mapping[str, torch.Tensor],
                  ctx: Optional[MeshContext], keys) -> Dict[str, torch.Tensor]:
    """metrics with `keys` summed over ctx's data group (the additive
    ones: losses normalised by global counts, counts); the rest as they
    are."""
    out = dict(metrics)
    if ctx is None or not ctx.grouped:
        return out
    names = [k for k in keys if k in out]
    if names:
        vec = torch.stack([out[k].detach().float().reshape(()) for k in names])
        dist.all_reduce(vec, group=ctx.data_group)
        out.update({k: vec[i].to(out[k].dtype) for i, k in enumerate(names)})
    return out


def broadcast_floats(ctx: Optional[MeshContext], values) -> List[float]:
    """Rank 0's floats on every rank (a float64 tensor where the default
    group's backend reduces: the card for NCCL, the CPU for gloo)."""
    if ctx is None or not ctx.grouped:
        return [float(v) for v in values]
    dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=dev)
    dist.broadcast(t, src=0)
    return t.tolist()


def barrier(ctx: Optional[MeshContext]) -> None:
    """Every rank of the process group waits here (files one rank wrote are
    then there for all)."""
    if ctx is not None and ctx.grouped:
        dist.barrier()


def sum_over_model(t: torch.Tensor, ctx: Optional[MeshContext]
                   ) -> torch.Tensor:
    """t summed over ctx's model group (a copy; no autograd)."""
    if ctx is None or ctx.n_model == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=ctx.model_group)
    return t


# ── Batches and parameters ───────────────────────────────────────────────

def local_rows(ctx: Optional[MeshContext], n: int) -> slice:
    """The rows of a global batch of n that ctx's data index owns."""
    if ctx is None or ctx.n_data == 1:
        return slice(0, n)
    if n % ctx.n_data:
        raise ValueError(f"global batch {n} not divisible by the data "
                         f"axis ({ctx.n_data})")
    k = n // ctx.n_data
    return slice(ctx.data_index * k, (ctx.data_index + 1) * k)


def local_batch(ctx: Optional[MeshContext], n: int) -> int:
    """This rank's share of a global batch of n (it must divide evenly
    over the data axis)."""
    rows = local_rows(ctx, n)
    return rows.stop - rows.start


def draw_rows(n_local: int, ctx: Optional[MeshContext]) -> Tuple[int, slice]:
    """(global batch, this rank's rows) of a train step whose inputs are a
    data-parallel rank's n_local rows: the step makes its random draws for
    the global batch and takes its rows, so a K-rank step draws what one
    process would (K1's noise is keyed by each image's seed, so it follows
    the image)."""
    n = n_local * (ctx.n_data if ctx is not None else 1)
    return n, local_rows(ctx, n)


def shard_batch(ctx: Optional[MeshContext], tree: Any) -> Any:
    """The rows this rank's data index owns of every array / tensor of a
    batch (a tuple, list or dict of them; the leading dim is the batch);
    all of them without a mesh."""
    if isinstance(tree, Mapping):
        return {k: shard_batch(ctx, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(ctx, v) for v in tree)
    return tree[local_rows(ctx, tree.shape[0])]


def gather_rows(ctx: Optional[MeshContext], tensors):
    """Each rank's rows of a tuple of batch tensors (a predict step's
    fixed-capacity outputs) gathered over ctx's data group, in data-index
    order: every rank gets the whole batch. bool goes through uint8 (gloo
    reduces no bool)."""
    if ctx is None or not ctx.grouped:
        return tensors
    out = []
    for t in tensors:
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.n_data)]
        dist.all_gather(parts, x, group=ctx.data_group)
        y = torch.cat(parts)
        out.append(y.bool() if t.dtype == torch.bool else y)
    return tuple(out)


def replicate_tree(ctx: Optional[MeshContext], tree: Any) -> Any:
    """Every tensor of a module (parameters and buffers) or of a dict of
    tensors broadcast from rank 0, in place; returns `tree`."""
    if ctx is None or not ctx.grouped:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    else:
        tensors = [t for t in tree.values() if torch.is_tensor(t)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree


# ── RT-DETR decoder tensor parallelism ───────────────────────────────────

@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split over the model axis along `dim`; with blocks > 1 the
    dim holds that many equal blocks (nn.MultiheadAttention's packed q, k,
    v), each split on its own."""
    dim: int
    blocks: int = 1


def _layer_leaf(name: str) -> Optional[str]:
    """The part of a parameter name after ``decoder.layers.{i}.``."""
    parts = name.split(".")
    for i in range(len(parts) - 2):
        if parts[i] == "layers" and parts[i + 1].isdigit() \
                and i > 0 and parts[i - 1] == "decoder":
            return ".".join(parts[i + 2:])
    return None


def rtdetr_decoder_tp(ctx: Optional[MeshContext], module: torch.nn.Module
                      ) -> Dict[str, Optional[Shard]]:
    """The reference's Megatron plan for the RT-DETR decoder, by parameter
    name (None: replicated). Per decoder layer: ``linear1`` split by its
    output features (weight rows, bias), ``linear2`` by its input features
    (weight columns; its bias replicated, added once after the reduce),
    the self-attention's q / k / v by heads (rows of each third of
    ``in_proj_weight`` / ``in_proj_bias``) and ``out_proj`` by its input
    features (its bias replicated). The optimizer's moments and the EMA
    follow their parameters' names."""
    plan: Dict[str, Optional[Shard]] = {}
    for name, _ in module.named_parameters():
        leaf = _layer_leaf(name)
        plan[name] = {"linear1.weight": Shard(0), "linear1.bias": Shard(0),
                      "linear2.weight": Shard(1),
                      "self_attn.in_proj_weight": Shard(0, 3),
                      "self_attn.in_proj_bias": Shard(0, 3),
                      "self_attn.out_proj.weight": Shard(1)}.get(leaf)
    return plan


def take_shard(t: torch.Tensor, spec: Optional[Shard], index: int,
               size: int) -> torch.Tensor:
    """Shard `index` of `size` of a full tensor (a copy)."""
    if spec is None or size == 1:
        return t.clone()
    blocks = t.chunk(spec.blocks, spec.dim)
    return torch.cat([b.chunk(size, spec.dim)[index] for b in blocks],
                     spec.dim).contiguous()


def gather_shards(t: torch.Tensor, spec: Optional[Shard],
                  ctx: Optional[MeshContext]) -> torch.Tensor:
    """The full tensor of a shard, gathered over ctx's model group."""
    if spec is None or ctx is None or ctx.n_model == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(ctx.n_model)]
    dist.all_gather(parts, t.contiguous(), group=ctx.model_group)
    per = [p.chunk(spec.blocks, spec.dim) for p in parts]
    return torch.cat([torch.cat([p[b] for p in per], spec.dim)
                      for b in range(spec.blocks)], spec.dim)


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": identity forward, sum over the model group
    backward (placed before a column-split layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": sum over the model group forward, identity backward
    (placed after a row-split layer)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def apply_tp(ctx: MeshContext, module: torch.nn.Module,
             plan: Mapping[str, Optional[Shard]]) -> None:
    """Replace every planned parameter of `module` by this rank's shard
    and hand the decoder layers the model group (their forward then runs
    the Megatron pattern). A no-op on a model axis of 1."""
    if ctx.n_model == 1:
        return
    layers = [sub for name, sub in module.named_modules()
              if _layer_leaf(name + ".x") == "x"]
    if not layers:
        raise ValueError("apply_tp: the module has no decoder layers")
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            spec = plan.get(name)
            if spec is None:
                continue
            owner = module.get_submodule(name.rsplit(".", 1)[0])
            leaf = name.rsplit(".", 1)[1]
            shard = take_shard(p.data, spec, ctx.model_index, ctx.n_model)
            setattr(owner, leaf, torch.nn.Parameter(
                shard, requires_grad=p.requires_grad))
    for sub in layers:
        sub.tp_group = ctx.model_group


def pad_batch_to(batch_arrays: Any, multiple: int) -> Any:
    """Pad the leading dim of every array of a batch (a tuple, list or dict
    of numpy arrays) up to a multiple, with zeros (so it divides the data
    axis)."""
    def pad(x):
        n = x.shape[0]
        p = (-n) % multiple
        if p == 0:
            return x
        return np.pad(x, [(0, p)] + [(0, 0)] * (x.ndim - 1))
    if isinstance(batch_arrays, Mapping):
        return {k: pad_batch_to(v, multiple) for k, v in batch_arrays.items()}
    if isinstance(batch_arrays, (tuple, list)):
        return type(batch_arrays)(pad_batch_to(v, multiple)
                                  for v in batch_arrays)
    return pad(batch_arrays)
