"""Batched one-to-one assignment for set matching (counterpart of
ops/assignment.py ``auction_assignment``).

RT-DETR's matcher needs 7 independent (Q x M) assignments a train step.
The algorithm is the Bertsekas forward auction (eps-optimal) with a round
cap and a greedy completion of the images that hit the cap:

  * bidders are the GT columns, items the queries; a round = every valid GT
    that owns no query bids ``v1 - w2 + eps`` on its best query (v1 the raw
    value there, w2 the second-best net value); a query takes its highest
    bid, ties to the lowest GT index;
  * an image with a valid GT still unassigned after ``max_rounds`` is
    ``capped`` and its matching is replaced by a from-scratch greedy solve
    (repeatedly the globally cheapest pair below ``BIG / 2``).

:func:`auction_assignment` launches ``auction_assign`` of
``csrc/auction.cu`` (K6: all rounds and the greedy completion in one
launch, one block per image) on CUDA tensors and runs the plain PyTorch
version (:func:`auction_assignment_plain`: :func:`auction_assignment_ref`
+ :func:`_greedy_owner`) on CPU tensors. Any other device, dtype or shape
raises. The algorithm is deterministic and every compare is an f32 compare
on the same values, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

BIG = 1e6          # prohibitive cost of a padded GT
_NEG = -1e18       # "no bid" sentinel


def _assigned_mask(owner: torch.Tensor, m: int) -> torch.Tensor:
    """owner (B, Q) -> (B, M) bool: GT m owns some query."""
    mids = torch.arange(m, device=owner.device)
    return (owner[:, :, None] == mids).any(1)


def auction_assignment_ref(cost: torch.Tensor, valid: torch.Tensor,
                           eps: float = 0.005, max_rounds: int = 150
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward auction, all images in lockstep, one pass of (B, M, Q)
    tensor ops a round. Returns (owner (B, Q) int32, the GT index of each
    query or -1; capped (B,) bool). No greedy completion."""
    b, qn, m = cost.shape
    dev = cost.device
    value = -cost.transpose(1, 2)                     # (B, M, Q), maximise
    qids = torch.arange(qn, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    price = torch.zeros((b, qn), dtype=torch.float32, device=dev)
    owner = torch.full((b, qn), -1, dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        bidding = valid & ~_assigned_mask(owner, m)   # (B, M)
        if not bool(bidding.any()):
            break
        net = value - price[:, None, :]               # (B, M, Q)
        net1, j1 = _first_max(net, -1)                # (B, M)
        at_j1 = qids[None, None, :] == j1[..., None]
        w2 = torch.where(at_j1, neg, net).amax(-1)
        v1 = net1 + torch.gather(price, 1, j1)
        bid_price = v1 - w2 + eps
        bidmat = torch.where(at_j1 & bidding[..., None],
                             bid_price[..., None], neg)   # (B, M, Q)
        best, winner = _first_max(bidmat, 1)          # (B, Q)
        won = best > _NEG / 2
        price = torch.where(won, best, price)
        owner = torch.where(won, winner, owner)
    capped = (valid & ~_assigned_mask(owner, m)).any(1)
    return owner.to(torch.int32), capped


def _first_max(x: torch.Tensor, dim: int):
    """(max, index of its FIRST occurrence) along dim, as jnp.argmax
    (torch.max's index among equal values is not specified)."""
    best = x.amax(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ids = torch.arange(n, device=x.device).reshape(shape)
    first = torch.where(x == best, ids, n).amin(dim)
    return best.squeeze(dim), first


def _greedy_owner(cost: torch.Tensor) -> torch.Tensor:
    """Plain greedy solve -> owner (B, Q) int32: repeatedly take the
    globally cheapest (query, GT) pair below BIG / 2 (ties to the lowest
    flat (q, m) index) and retire its row and column. The pick loop is
    bounded by the largest count of assignable GT columns in the batch."""
    b, qn, m = cost.shape
    dev = cost.device
    n_assignable = (cost.amin(1) < BIG / 2).sum(1)
    n_iter = min(int(n_assignable.max()), qn, m)
    q_used = torch.zeros((b, qn), dtype=torch.bool, device=dev)
    m_used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    owner = torch.full((b, qn), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    for _ in range(n_iter):
        masked = cost + (q_used[:, :, None] | m_used[:, None, :]) * BIG
        best, idx = _first_max(-masked.reshape(b, -1), 1)
        qi, mi = idx // m, idx % m
        take = -best < BIG / 2
        owner[rows[take], qi[take]] = mi[take]
        q_used[rows[take], qi[take]] = True
        m_used[rows[take], mi[take]] = True
    return owner.to(torch.int32)


def auction_assignment_plain(cost: torch.Tensor, valid: torch.Tensor,
                             eps: float = 0.005, max_rounds: int = 150,
                             complete_greedy: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version, on the tensors' device: the round loop, then the
    greedy solve for the capped images. It syncs with the host every round
    and every pick."""
    owner, capped = auction_assignment_ref(cost, valid, eps, max_rounds)
    if complete_greedy and bool(capped.any()):
        owner = torch.where(capped[:, None], _greedy_owner(cost), owner)
    return owner, capped


def _check(cost, valid) -> None:
    if cost.dim() != 3 or valid.dim() != 2 or 0 in cost.shape:
        raise ValueError(f"auction_assignment takes cost (B,Q,M) and valid "
                         f"(B,M), no empty dimension, got "
                         f"{tuple(cost.shape)}, {tuple(valid.shape)}")
    if tuple(valid.shape) != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"auction_assignment: valid {tuple(valid.shape)} "
                         f"does not match cost {tuple(cost.shape)}")
    if cost.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"auction_assignment takes float32 cost and bool "
                         f"valid, got {cost.dtype}, {valid.dtype}")
    if valid.device != cost.device:
        raise ValueError("auction_assignment: cost and valid must be on one "
                         "device")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"auction_assignment runs on cpu or cuda, got "
                         f"{cost.device}")


@torch.no_grad()
def auction_assignment(cost: torch.Tensor, valid: torch.Tensor,
                       eps: float = 0.005, max_rounds: int = 150,
                       complete_greedy: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve B independent (Q, M) assignments. cost (B, Q, M) f32, padded
    GTs at a prohibitive cost >= BIG; valid (B, M) bool, the real-GT mask
    (padded GTs never bid). Returns (gt_for_query (B, Q) int32, -1 =
    unmatched; capped (B,) bool). With ``complete_greedy`` a capped image's
    matching is the greedy solve."""
    _check(cost, valid)
    if cost.device.type == "cpu":
        return auction_assignment_plain(cost, valid, eps, max_rounds,
                                        complete_greedy)
    b, qn, m = cost.shape
    value = (-cost.transpose(1, 2)).contiguous()
    valid = valid.contiguous()
    owner = torch.empty((b, qn), dtype=torch.int32, device=cost.device)
    capped = torch.empty((b,), dtype=torch.int32, device=cost.device)
    lib = kernels.load()
    with torch.cuda.device(cost.device):
        err = lib.auction_assign(
            value.data_ptr(), valid.data_ptr(), owner.data_ptr(),
            capped.data_ptr(), b, qn, m, float(eps), int(max_rounds),
            int(bool(complete_greedy)), kernels.stream_ptr(cost.device))
    kernels.check(err, "auction_assign")
    auction_assignment.launches += 1
    return owner, capped != 0


auction_assignment.launches = 0
