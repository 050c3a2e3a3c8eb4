"""Multi-process scaffolding: ``torch.distributed`` init + per-process data
(counterpart of robust_object_detection_tpu/parallel/distributed.py).

  * ``maybe_initialize()`` — env-driven ``torch.distributed.
    init_process_group``: NCCL when the process runs on the card, gloo when
    the caller asks for the CPU; a no-op that returns False when the
    environment names no process group.
  * per-process input: ``shard_samples`` gives each process its row shard,
    ``local_batch_size`` its slice of the global batch.
  * ``is_primary()`` — process-0 discipline for JSON / CSV / plot
    artifacts.

Environment contract (set by the launcher; all optional on one process):

  ROD_COORDINATOR   host:port of process 0 (also MASTER_ADDR + MASTER_PORT)
  ROD_NUM_PROCESSES total process count   (or WORLD_SIZE)
  ROD_PROCESS_ID    this process's index  (or RANK)

``ROD_AUTO_DISTRIBUTED=1`` initialises from ``env://`` as a launcher such
as torchrun sets it up. Data parallelism of the trainers and the decoder's
tensor parallelism (the reference's parallel/mesh.py) are not ported.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

def _backend(device: Union[None, str, torch.device]) -> str:
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl"


def maybe_initialize(device: Union[None, str, torch.device] = None) -> bool:
    """Initialize torch.distributed from the environment; False if unset.

    device: where this process computes (None: the CUDA card, NCCL; "cpu":
    gloo). Idempotent: safe to call from every entry point."""
    if _grouped():
        return True
    backend = _backend(device)
    if os.environ.get("ROD_AUTO_DISTRIBUTED") == "1":
        _init(backend, "env://", None, None)
        return True
    coord = os.environ.get("ROD_COORDINATOR")
    if not coord and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nproc = (os.environ.get("ROD_NUM_PROCESSES")
             or os.environ.get("WORLD_SIZE"))
    pid = os.environ.get("ROD_PROCESS_ID") or os.environ.get("RANK")
    if not (coord and nproc and pid):
        return False
    _init(backend, f"tcp://{coord}", int(nproc), int(pid))
    return True


def _init(backend: str, url: str, world: Optional[int],
          rank: Optional[int]) -> None:
    kw = {} if world is None else {"world_size": world, "rank": rank}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("maybe_initialize: no CUDA card for NCCL; "
                               "ask for the CPU (gloo) instead")
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(r % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, **kw)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _grouped() else 0


def _world() -> int:
    return dist.get_world_size() if _grouped() else 1


def is_primary() -> bool:
    """True on the artifact-writing process (one process: always)."""
    return _rank() == 0


def shard_samples(samples: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """This process's row shard of a sample list (strided): process k takes
    samples[k::count]. Every process must end with the SAME number of
    batches, so the list is truncated to a multiple of the process count
    first."""
    pc = process_count if process_count is not None else _world()
    pi = process_index if process_index is not None else _rank()
    if pc == 1:
        return list(samples)
    n = (len(samples) // pc) * pc
    return list(samples[pi:n:pc])


def local_batch_size(global_batch: int) -> int:
    """Per-process slice of the global batch (must divide evenly)."""
    pc = _world()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} processes")
    return global_batch // pc
