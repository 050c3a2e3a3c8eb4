#!/usr/bin/env python3
"""Where the deformable-attention backward's time goes on one CUDA card:
copies of csrc/deform_bwd.cu (and csrc/owner_scatter.cuh) with one step
cut out or one choice changed, each built into its own library and timed
side by side.

    python3 tools/profile_torch_deform_cuts.py

At the RT-DETR-L train shapes (values (8, 21504, 8, 32), 428 queries, 3
levels x 4 points, seeded inputs as in chip_smoke.py), uniform samples,
bf16 values with bf16 dout (K5's backward), bf16 values with f32 dout
(K5-g2's) and f32: the profiler's device ms of the taps kernel and the
scatter for each copy, and whether its d(values) has the full kernel's
bits. The copies:

  full          the kernels as they are;
  no_walk       the scatter scans and stores, adds nothing;
  no_scan       the scatter zeroes its tile and stores it, scans nothing
                (and meets no barrier: a time, not a result);
  no_dout       the scatter's terms without their dout loads;
  no_add_chain  each batch's terms summed in registers, one shared add;
  level0_only   only the blocks of the finest level run;
  levels12_only only the blocks of the coarser levels run;
  no_reg_cap    the scatter without its 64-register cap;
and the full kernels with other level tiles (cells a tile, finest level
first). Last, torch copies that write the (8, 21504, 8, 32) d(values)
shape whole and one head at a time (64-byte pieces in bf16), to show
what the store's access pattern costs by itself. Needs one CUDA card and
nvcc; the copies are built under the package's _build/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

SCATTER = "deform_bwd_scatter_kernel"
LEVELS = "    if (k < L && bt.first[k] <= t) l = k;\n"
WALK = ("        stamp_walk(list, n, tbase, contrib, chan, trow,\n"
        "                   cnt + 2 * STAMP_WARPS + warp * STAMP_RING);")
SCAN = ("    owner_scatter(ir, l * tpl, (l + 1) * tpl, c0, ncell, tile, DH,\n"
        "                  ivec != 0, term, store, smem);\n  } else")
ADDS = ("  for (int k = 0; k < STAMP_BATCH; ++k)\n"
        "    if (chan && cell[k] >= 0) trow[cell[k]] += v[k];")
CUTS = {
    "full": [],
    "no_walk": [("owner_scatter.cuh", WALK, "")],
    "no_scan": [("deform_bwd.cu", SCAN,
                 SCAN.replace("l * tpl, (l + 1) * tpl", "0, 0"))],
    "no_dout": [("deform_bwd.cu",
                 "? to_f(dch[(size_t)qk * qs]) : 0.f;", "? (float)qk : 0.f;")],
    "no_add_chain": [("owner_scatter.cuh", ADDS, (
        "  float acc = 0.f;\n"
        "  for (int k = 0; k < STAMP_BATCH; ++k)\n"
        "    if (chan && cell[k] >= 0) acc += v[k];\n"
        "  if (chan) trow[cell[0]] += acc;"))],
    "level0_only": [("deform_bwd.cu", LEVELS,
                     LEVELS + "  if (l != 0) return;\n")],
    "levels12_only": [("deform_bwd.cu", LEVELS,
                       LEVELS + "  if (l == 0) return;\n")],
    "no_reg_cap": [("deform_bwd.cu", "__launch_bounds__(STAMP_THREADS, 4)",
                    "__launch_bounds__(STAMP_THREADS)")],
}
TILES = [(256, 128, 64), (256, 64, 16), (512, 512, 512)]


def build(kernels, name, edits, out):
    """Starts nvcc on a copy of csrc/ with `edits` applied; returns the
    library's path and the process."""
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for p in kernels.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            (d / p.name).write_text(p.read_text())
    for fname, old, new in edits:
        src = (d / fname).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"cut {name}: text not found in {fname}")
        (d / fname).write_text(src.replace(old, new))
    so = d / "lib.so"
    return so, subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(d), "-o",
         str(so), str(d / "deform_bwd.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch

    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import deform as DF

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    print(S.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]))
    out = kernels.BUILD_DIR / "cuts"
    jobs = {n: build(kernels, n, e, out) for n, e in CUTS.items()}
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[cuts] {name}: nvcc failed\n{log[-2000:]}")
            return 1
        regs = sorted({line.split(",")[0] for fn, line in
                       S.ptxas_report(log)
                       if SCATTER in fn and "registers" in line})
        lib = ctypes.CDLL(str(so))
        lib.ms_deform_attn_bwd.argtypes = kernels.SIGNATURES[
            "ms_deform_attn_bwd"]
        libs[name] = lib
        print(f"[cuts] {name}: built; scatter: {'; '.join(regs)}")

    dev = torch.device("cuda", 0)
    shapes = S.RTDETR_LEVELS
    b, heads, dh, pts = (S.RTDETR_TRAIN_BATCH, S.RTDETR_HEADS, S.RTDETR_DH,
                         S.RTDETR_POINTS)
    q = S.RTDETR_QUERIES + 2 * 2 * 32
    g = torch.Generator(dev).manual_seed(S.SEED + 5)
    values, loc, attn = S.deform_inputs(g, shapes, b, q, heads, dh, pts, dev)
    dout = torch.randn(b, q, heads, dh, device=dev, generator=g)

    def call(lib, vd, dd, tiles=None):
        table, args, taps = DF._bwd_plan(b * heads, shapes, q, pts, dh,
                                         vd.element_size(), True, False)
        keep = (ctypes.c_int * len(shapes))(*(tiles or table[0]))
        cell = torch.empty((b * heads, taps), dtype=torch.int32, device=dev)
        coef = torch.empty((b * heads, taps), device=dev)
        dloc, dattn = torch.empty_like(loc), torch.empty_like(attn)
        dv = torch.empty_like(vd)
        err = lib.ms_deform_attn_bwd(
            vd.data_ptr(), loc.data_ptr(), attn.data_ptr(), dd.data_ptr(),
            dloc.data_ptr(), dattn.data_ptr(), cell.data_ptr(),
            coef.data_ptr(), dv.data_ptr(), DF._levels_table(shapes)[1],
            ctypes.addressof(keep), b, vd.shape[1], q, heads, dh,
            len(shapes), pts, kernels.dtype_code(vd.dtype),
            kernels.dtype_code(dd.dtype), 0, *args,
            torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "ms_deform_attn_bwd")
        return dv

    def parts(fn):
        seq = S.device_ms_by_launch(fn) or [
            (t, k) for t, _, k in S.device_ms_by_kernel(fn)]
        return "; ".join(f"{S.short_kernel_name(k).split('<')[0]} {t}"
                         for t, k in seq)

    for vdt, ddt in ((torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32),
                     (torch.float32, torch.float32)):
        vd, dd = values.to(vdt), dout.to(ddt)
        full = call(libs["full"], vd, dd)
        what = f"values {str(vdt)[6:]} dout {str(ddt)[6:]}"
        for name, lib in libs.items():
            same = torch.equal(call(lib, vd, dd), full)
            print(f"[cuts] {what} {name}: {parts(lambda: call(lib, vd, dd))}"
                  f"; d(values) bits of full {same}", flush=True)
        for tiles in TILES:
            same = torch.equal(call(libs["full"], vd, dd, tiles), full)
            print(f"[cuts] {what} level tiles {tiles}: "
                  f"{parts(lambda: call(libs['full'], vd, dd, tiles))}; "
                  f"d(values) bits of full {same}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        dst = torch.empty(b, values.shape[1], heads, dh, dtype=dtype,
                          device=dev)
        src = torch.randn(b, heads, values.shape[1], dh, device=dev,
                          generator=g).to(dtype)
        whole = S.time_ms(lambda: dst.copy_(src.permute(0, 2, 1, 3)))
        by_head = S.time_ms(lambda: [dst[:, :, h].copy_(src[:, h])
                                     for h in range(heads)])
        piece = dh * dst.element_size()
        print(f"[cuts] writing {dst.numel() * dst.element_size() / 1e6} MB "
              f"of {str(dtype)[6:]} (B, HW, heads, dh): whole rows {whole} "
              f"ms, one head at a time ({piece}-byte pieces) {by_head} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
