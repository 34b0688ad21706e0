"""Data parallelism over a torch.distributed group (counterpart of the JAX
package's `parallel/mesh.py`).

The JAX package builds a 1-D 'data' mesh in one process per host,
replicates the state over it and shards the batch's leading axis; XLA's
SPMD partitioner then inserts the gradient all-reduce and takes BatchNorm
statistics over the global batch. Here each rank is one process on one
device (or, with the gloo backend, several processes on one card), and
the port does both explicitly: `engine/csmodel.py` averages the step's
gradients over the group (`all_reduce_mean`) and `models/unet_lib.py`'s
BatchNorm reduces its per-channel sums over it.

  * make_mesh: join (or wrap) a torch.distributed group -> Mesh(size,
    rank, device, group, backend); nccl for CUDA, gloo for the CPU, or
    the `backend` asked for (gloo puts several ranks on one card).
  * replicate_state: broadcast a CSModel's parameters, buffers, mask and
    Adam state from rank 0.
  * shard_batch: this rank's rows [r n / W, (r + 1) n / W) of a batch.
  * gather_rows: rows that the ranks hold, at their global positions, as
    the whole batch on every rank.
  * all_reduce_mean: the mean over the group, coalesced into one flat
    buffer a dtype; all_reduce_sum: a differentiable sum.
  * split_rows: each rank's share of a batch that forwardG halves.
  * launch: one process per local device, each running a function on
    its mesh (the CLIs' `--data_parallel`).

Every collective is an `all_reduce` or a `broadcast`: those are the two
that gloo takes on CUDA tensors, so one code path serves nccl on cards,
gloo on the CPU and gloo with several ranks on one card. The JAX module's
`dp_shardings` and `shard_batch_multihost` have no counterpart: there is
no jit to give shardings to, and every process already holds its own
rows.
"""

import dataclasses
import os
import pickle
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel group: `size` ranks, this one `rank`, its
    tensors on `device`."""

    size: int
    rank: int
    device: torch.device
    group: object
    backend: str


def in_world() -> bool:
    """Whether this process is a rank of a world already: a joined group,
    or torchrun's environment (RANK and WORLD_SIZE)."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def world_size() -> int:
    """The size of the world this process is a rank of (1 outside one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if in_world() else 1


def make_mesh(device="cuda", backend=None, init_method=None, rank=None,
              world_size=None) -> Mesh:
    """Join the world (or wrap the one this process joined) as a Mesh.

    Without a joined group: `init_method` with `rank` and `world_size`
    (a `tcp://` or `file://` rendezvous), else torchrun's environment
    ("env://"), else a world of 1. `device` "cuda" is this rank's card
    (LOCAL_RANK, or the rank modulo the cards), and the backend nccl
    unless `backend` says otherwise; "cpu" takes gloo. The world's size
    is the mesh's: the JAX function's `n_devices` has no counterpart, as
    a rank cannot leave its group. Raises rather than fall back: no card
    for "cuda", nccl for the CPU."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if init_method is not None or rank is not None:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
        elif in_world():
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the joined group runs {dist.get_backend()}, not {backend}")
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl takes CUDA tensors alone: use a card or the gloo backend")
    size, rank = dist.get_world_size(), dist.get_rank()
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else rank % torch.cuda.device_count()
            device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    return Mesh(size, rank, device, dist.group.WORLD, backend)


# ------------------------------------------------------------ collectives
def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as the collectives carry it: complex as its real pairs, bool as
    bytes."""
    if t.is_complex():
        return torch.view_as_real(t)
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t


def _coalesced_(mesh: Mesh, tensors, collective):
    """Run `collective(flat)` in place on one flat buffer a wire dtype,
    on the mesh's device, and copy the results back into `tensors`."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(_wire(t).dtype, []).append(t)
    for ts in by_dtype.values():
        wires = [_wire(t) for t in ts]
        flat = torch.cat([w.reshape(-1).to(mesh.device) for w in wires])
        collective(flat)
        offset = 0
        for t, w in zip(ts, wires):
            piece = flat[offset:offset + w.numel()].view(w.shape)
            offset += w.numel()
            if t.dtype == torch.bool:
                t.copy_(piece.to(torch.bool))
            else:
                w.copy_(piece)
    return tensors


def all_reduce_mean(mesh: Mesh, tensors):
    """Replace each tensor of `tensors` by its mean over the group, in
    place (one all_reduce a dtype); returns `tensors`."""
    def mean_(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)

    return _coalesced_(mesh, list(tensors), mean_)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose gradient is the sum over the group of
    the ranks' output gradients (each rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the group, differentiable (BatchNorm's global
    statistics)."""
    return _AllReduceSum.apply(x, mesh.group)


def broadcast_(mesh: Mesh, tensors, src=0):
    """Overwrite each tensor of `tensors` with rank `src`'s, in place (one
    broadcast a dtype); returns `tensors`."""
    return _coalesced_(mesh, list(tensors),
                       lambda flat: dist.broadcast(flat, src, group=mesh.group))


def broadcast_int(mesh: Mesh, value: int, src=0) -> int:
    """Rank `src`'s integer `value` on every rank."""
    (t,) = broadcast_(mesh, [torch.tensor([value], dtype=torch.int64)], src)
    return int(t)


def row_counts(mesh: Mesh, n: int) -> list:
    """Every rank's row count [n_0, ..., n_W-1], given this rank's `n`."""
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = n
    dist.all_reduce(counts, group=mesh.group)
    return counts.tolist()


def gather_rows(mesh: Mesh, tensors, index=None, total=None) -> list:
    """The whole batch on every rank from the rows each rank holds: each
    tensor of `tensors` holds the global rows `index` (default this rank's
    contiguous shard of equal shards) of a batch of `total` rows. An
    all_reduce of zero-filled buffers in which each rank wrote its own
    rows (gloo gathers no CUDA tensors)."""
    n = tensors[0].shape[0]
    if index is None:
        index = torch.arange(mesh.rank * n, (mesh.rank + 1) * n)
        total = n * mesh.size
    index = torch.as_tensor(index, dtype=torch.int64, device=tensors[0].device)
    out = []
    for t in tensors:
        buf = torch.zeros((total,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        buf[index] = t
        out.append(buf)
    return _coalesced_(mesh, out, lambda flat: dist.all_reduce(flat, group=mesh.group))


def shard_batch(mesh: Mesh, x):
    """This rank's rows [r n / W, (r + 1) n / W) of batch `x` (a tensor or
    numpy array): the JAX package's row order."""
    n = x.shape[0]
    return x[mesh.rank * n // mesh.size:(mesh.rank + 1) * n // mesh.size]


def replicate_state(mesh: Mesh, model):
    """Broadcast from rank 0 every tensor of CSModel `model` that a step
    reads: each net's parameters and buffers (BatchNorm statistics,
    spectral-norm u and v), net_mask's weight, `pruned`, and every Adam
    state tensor. The ranks must hold models of the same structure."""
    tensors = [model.pruned]
    for name in ("net_G", "net_D", "net_T", "net_R", "net_mask"):
        net = getattr(model, name)
        tensors += list(net.parameters()) + list(net.buffers())
    for opt in model.opt.values():
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                            if torch.is_tensor(v)]
    with torch.no_grad():
        broadcast_(mesh, tensors)


def split_rows(rows, n1: int, size: int) -> list:
    """Each rank's share of the global rows `rows` of a batch that
    forwardG halves at n1 (n1 = len(rows): no halving): [(indices, k)]
    a rank, its rows in order and k of them from the first half. Each
    half is cut into contiguous parts, the first's larger parts to the
    low ranks and the second's to the high ranks, so that every rank
    holds len(rows) / size rows when `size` divides it."""
    rows = np.asarray(rows)
    first, second = rows[:n1], rows[n1:]
    a = np.array_split(first, size)
    cuts = np.cumsum([0] + [len(p) for p in np.array_split(second, size)][::-1])
    return [(np.concatenate([a[r], second[cuts[r]:cuts[r + 1]]]), len(a[r]))
            for r in range(size)]


# ------------------------------------------------------------------ launch
def launch(fn, *args, device="cuda", coordinator=None, num_processes=1, process_id=0):
    """Run fn(mesh, *args) in one process per local device: each card
    ("cuda"; the CPU counts as one device), on a world of num_processes x
    local devices, rank process_id x local + local index. The ranks meet
    at `coordinator` (HOST:PORT, the host of process 0) or, on one host,
    in a file store under the temporary directory. Returns rank 0's
    result where this process launched rank 0, else None; a rank that
    raises stops the others and raises here."""
    device = torch.device(device)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    if local < 1:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    tmp = tempfile.mkdtemp(prefix="san_dp_")
    init = (f"tcp://{coordinator}" if coordinator
            else "file://" + os.path.join(tmp, "store"))
    result = os.path.join(tmp, "result.pkl")
    try:
        torch.multiprocessing.spawn(
            _launched, nprocs=local,
            args=(fn, args, device.type, init, process_id * local, num_processes * local,
                  result))
        if not os.path.exists(result):
            return None
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _launched(local, fn, args, device_type, init, offset, world, result):
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    mesh = make_mesh(device=device, init_method=init, rank=offset + local, world_size=world)
    try:
        out = fn(mesh, *args)
        if mesh.rank == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
