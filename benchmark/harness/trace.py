"""The reduction of a device trace (``torch.profiler``, kernels and copies
on the card, the host's ops beside them) to the numbers the per-layer
metrics read: the device's busy time (the union of its kernel and copy
intervals), launches, device time by kernel group, and the breakdown the
result line carries.

``LAUNCH_APIS``, ``kernel_group`` and ``union_us`` are frozen copies of
``tools/profile_torch_sweep.py`` and ``chip_smoke.py`` (commit bdbb134), so
that an edit there cannot move the yardstick.
"""

from __future__ import annotations

import bisect
import math
import re
from typing import Dict, Iterable, List, Tuple

LAUNCH_APIS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx"}


def kernel_group(name: str, rtdetr: bool = False) -> str:
    """The group of a device kernel by its name. `rtdetr`: the stride-2
    weight gradients, the BN-chain kernels and the front_tc.cuh /
    front_tf32.cuh kernels belong to K4 (the HGNetv2 stem, whose stride-2
    convs run them), not to K2 (the YOLO front's; no path runs both). The
    CUDA-core kernels that the f32 routes ran before their split-TF32
    kernels are kept by name, for measuring an older checkout (--root)."""
    if "conv3x3_tc_kernel" in name or "conv3x3_tf32_kernel" in name:
        return "K3-f conv3x3"
    if re.search(r"front_p[12]_kernel", name):
        return "K4-f hgstem" if rtdetr else "K2-f yolo_front"
    if re.search(r"e2_prep_kernel|front_d(a1|k1|k2)_tc_kernel", name):
        return "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    if re.search(r"front_p[12]_tf32_kernel", name):
        return "K4-f hgstem" if rtdetr else "K2-f yolo_front"
    if re.search(r"e2_prep_f32_kernel|front_d(a1|k1|k2)_tf32_kernel", name):
        return "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    if re.search(r"stem2x2_t(c|f32)_kernel|pool2x2_(vec|f32)_kernel|"
                 r"assemble_train_(vec|f32)_kernel", name):
        return "K4-f hgstem"
    if re.search(r"stem2x2_(dx|wgrad)_t(c|f32)_kernel|"
                 r"assemble_bwd_(vec|f32)_kernel", name):
        return "K4-b hgstem_bwd"
    if "wgrad_tc_kernel" in name or "wgrad_tf32_kernel" in name:
        return "K3-b conv3x3_wgrad"
    m = re.search(r"conv3x3_tile_kernel<[^,>]+, (\d), [^,>]+, (\d)", name)
    if m:       # stride, then the activation (1: ReLU, the HGNetv2 stem)
        if m.group(2) == "1":
            return "K4-f hgstem"
        return "K2-f yolo_front" if m.group(1) == "2" else "K3-f conv3x3"
    if re.search(r"conv2x2_relu_kernel|pool2x2_kernel|assemble_train_kernel",
                 name):
        return "K4-f hgstem"
    if re.search(r"stem3_dx_kernel|assemble_bwd_kernel|conv2x2_dx_kernel",
                 name):
        return "K4-b hgstem_bwd"
    if "ms_deform_attn_bwd_kernel" in name:
        return "K5 bwd ms_deform_attn"
    if "ms_deform_attn_kernel" in name:
        return "K5 ms_deform_attn"
    if "auction_kernel" in name:
        return "K6 auction"
    front_bwd = "K4-b hgstem_bwd" if rtdetr else "K2-b yolo_front_bwd"
    m = re.search(r"wgrad_partial_kernel<[^,>]+, (\d), [^,>]+, (\d)", name)
    if m:       # stride, then the input transform's activation (1: ReLU)
        if m.group(1) == "2" or m.group(2) == "1":
            return front_bwd
        return "K3-b conv3x3_wgrad"
    if re.search(r"front_da1_kernel|bn_chain_kernel|stat_cotangent", name):
        return front_bwd
    if re.search(r"finalize_partials_kernel|sum_chunks_(tc_)?kernel", name):
        return "hand-kernel partial sums (K2-f, K2-b, K3-b, K4-f, K4-b)"
    if re.search(r"corrupt_(tile_)?kernel", name):
        return "K1 corrupt"
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "bn_fw" in low or "batch_norm" in low:
        return "cuDNN batch norm"
    if any(t in low for t in ("xmma", "implicit_gemm", "nvjet", "cutlass",
                              "gemm", "conv")):
        return "cuDNN/cuBLAS conv"
    if "elementwise" in low or "catarray" in low or "upsample" in low:
        return "PyTorch elementwise"
    if "layer_norm" in low or "softmax" in low or "attention" in low \
            or "fmha" in low or "flash" in low:
        return "PyTorch attention / layer norm / softmax"
    if "reduce" in low:
        return "PyTorch reductions"
    return "other (topk, sort, gather, scatter, ...)"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


HAND_KERNEL_PARTIALS = ("hand-kernel partial sums (K2-f, K2-b, K3-b, K4-f, "
                        "K4-b)")
ELEMENTWISE_GROUPS = ("PyTorch elementwise", "PyTorch reductions")


def is_hand_kernel(group: str) -> bool:
    """The groups of the program's own CUDA kernels (csrc/*.cu)."""
    return bool(re.match(r"K\d", group)) or group == HAND_KERNEL_PARTIALS


def device_profile(device):
    """A profiler of the card's activity and the CUDA runtime calls only:
    recording every host op as well would slow the host and open idle gaps
    that the untraced window does not have. On the CPU (the tests), the
    host's ops."""
    from torch.profiler import ProfilerActivity, profile

    cuda = getattr(device, "type", str(device)) == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def reduce_profile(prof, wall_s: float, rtdetr: bool = False,
                   top: int = 10, min_gap_us: float = 0.0) -> dict:
    """The numbers of one profiled segment of `wall_s` host seconds (a
    trace of the card's activity and of the CUDA runtime calls).

    Returns {"wall_s", "busy_s", "launches", "launch_api_s", "by_group":
    {group: [device ms, kernels]}, "device_ops": [[name, s], ...],
    "idle_gaps": [[host activity, s], ...]}: the `top` device operations
    by total time, and the device's idle time (gaps of at least
    `min_gap_us`) summed by the runtime call the host was in at each gap's
    middle ("host outside CUDA calls": in Python or a host library)."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev, host = [], []
    launches, launch_us = 0, 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # kernels and copies only: a GPU-side user annotation spans
            # the card's idle gaps too
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        else:
            if e.name in LAUNCH_APIS:
                launches += 1
                launch_us += e.time_range.elapsed_us()
            host.append((e.time_range.start, e.time_range.end, e.name))
    by_kernel: Dict[str, List[float]] = {}
    for s, t, name in dev:
        k = by_kernel.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e3
        k[1] += 1
    by_group: Dict[str, List[float]] = {}
    for name, (ms, n) in by_kernel.items():
        g = by_group.setdefault(kernel_group(name, rtdetr), [0.0, 0])
        g[0] += ms
        g[1] += n
    busy_us = union_us((s, t) for s, t, _ in dev)
    return {"wall_s": wall_s, "busy_s": busy_us / 1e6, "launches": launches,
            "launch_api_s": launch_us / 1e6, "by_group": by_group,
            "device_ops": [[n, v[0] / 1e3] for n, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][0])[:top]],
            "idle_gaps": idle_gaps(dev, host, top, min_gap_us)}


def idle_gaps(dev: Iterable[Tuple[float, float, str]],
              host: List[Tuple[float, float, str]], top: int,
              min_gap_us: float) -> List[list]:
    """The device's idle gaps between its first and last operation, summed
    by the innermost host event running at each gap's middle ("host
    outside CUDA calls" where none was)."""
    spans = sorted((s, t) for s, t, _ in dev)
    gaps, end = [], -math.inf
    for s, t in spans:
        if end > -math.inf and s - end >= min_gap_us:
            gaps.append((end, s))
        end = max(end, t)
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host outside CUDA calls"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]
