#!/usr/bin/env python3
"""Where K2's f32 kernels spend their time, without ncu: copies of this
checkout with one part of csrc/front_tf32.cuh cut out, built beside each
other and timed with this one on one CUDA card.

    python3 tools/profile_torch_front_cuts.py [--dest DIR] [--only NAME ...]

Cuts (a copy computes wrong values; only its times mean anything):
  p2_transform   P2's in-place a1 = silu(g1 y1 + b1) on each staged stage;
  p2_split       P2's fragments unsplit (hi = lo = the f32 bits);
  da1_split      dA1's fragments unsplit;
  da1_y1         dA1's epilogue without its y1 loads;
  dk2_transform  dk2's a1 = silu(g1 y1 + b1) in its split pass;
  dk2_pass       dk2's whole split pass (nothing written to the quads);
  dk2_mma        dk2's MMAs.
Each copy (DIR/<name>, default $TMPDIR/front_cuts) is built by its own
process, all at once, then tools/profile_torch_front.py --dtype float32
--root times this checkout and each copy in turn: the device ms of each
kernel of K2-f eval, K2-f train and K2-b. Needs nvcc and one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "robust_object_detection_tpu_torch/csrc/front_tf32.cuh"

_P2_TRANSFORM = '''        v.x = act_fast<ACT_SILU>(v.x * gq[0] + bq[0]);
        v.y = act_fast<ACT_SILU>(v.y * gq[1] + bq[1]);
        v.z = act_fast<ACT_SILU>(v.z * gq[2] + bq[2]);
        v.w = act_fast<ACT_SILU>(v.w * gq[3] + bq[3]);
'''
_P2_SPLIT_A = '''                              (kx >> 1)) * P2_HS) * E);
        split4(r, ah[i], al[i]);'''
_P2_SPLIT_B = '''        ldsm_x4(r, b_base + ((tap * P2_NP + 16 * jj) * P2_FCI) * E);
        split4(r, h, l);'''
_DA1_SPLIT_A = '''          ldsm_x4(r, a_base + (((i + dr) * PC + dc) * DA_KS + 8 * k8) * E);
          split4(r, ah[i], al[i]);'''
_DA1_SPLIT_B = '''          ldsm_x4(r, b_row + b_off + (tap * DA_ND * DA_FK) * E);
          split4(r, h, l);'''
_DA1_SPLIT_B2 = '''          split_tf32(__uint_as_float(r2[0]), bh[2][0], bl[2][0]);
          split_tf32(__uint_as_float(r2[1]), bh[2][1], bl[2][1]);'''
_DA1_Y1 = '''              if (ok && C1 % 2 == 0 && c < C1) {
                const float2 t = *reinterpret_cast<const float2*>(y1 + off);
                yv[i][j][h][0] = t.x, yv[i][j][h][1] = t.y;
              } else if (ok && C1 % 2 != 0) {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (c + e < C1) yv[i][j][h][e] = y1[off + e];
              }'''
_DK2_TRANSFORM = '''      if (halo_offset(p, b, oy0, ox0, H2, W2, 1) >= 0) {
        v.x = act_fast<ACT_SILU>(v.x * gq[0] + bq[0]);
        v.y = act_fast<ACT_SILU>(v.y * gq[1] + bq[1]);
      }
'''
_DK2_QUADS = ("      put_quad(sx + p * XS + 4 * pq, v.x, v.y);\n",
              "      put_quad(sd + p * XS + 4 * pq, v.x, v.y);\n")
_DK2_MMA = '''    if (half == 0)
      mmas(std::integral_constant<int, 0>());
    else
      mmas(std::integral_constant<int, 1>());
'''
_COPY_A = "for (int q = 0; q < 4; ++q) ah[i][q] = al[i][q] = r[q];"
_COPY_B = "for (int q = 0; q < 4; ++q) h[q] = l[q] = r[q];"

CUTS = {
    "p2_transform": [(_P2_TRANSFORM, "")],
    "p2_split": [(_P2_SPLIT_A, _P2_SPLIT_A.replace(
                     "split4(r, ah[i], al[i]);", _COPY_A)),
                 (_P2_SPLIT_B, _P2_SPLIT_B.replace("split4(r, h, l);",
                                                   _COPY_B))],
    "da1_split": [(_DA1_SPLIT_A, _DA1_SPLIT_A.replace(
                      "split4(r, ah[i], al[i]);", _COPY_A)),
                  (_DA1_SPLIT_B, _DA1_SPLIT_B.replace("split4(r, h, l);",
                                                      _COPY_B)),
                  (_DA1_SPLIT_B2, "          bh[2][0] = bl[2][0] = r2[0], "
                                  "bh[2][1] = bl[2][1] = r2[1];")],
    "da1_y1": [(_DA1_Y1, "              yv[i][j][h][0] = 1e-3f * off;")],
    "dk2_transform": [(_DK2_TRANSFORM, "")],
    "dk2_pass": [(_DK2_TRANSFORM, ""), (_DK2_QUADS[0], ""),
                 (_DK2_QUADS[1], "")],
    "dk2_mma": [(_DK2_MMA, "")],
}
_BUILD = ("from robust_object_detection_tpu_torch import kernels; "
          "kernels.build()")


def make(dest: Path, name: str) -> Path:
    """DEST/name: a copy of the port with cut `name` made in its header."""
    d = dest / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT, d, ignore=shutil.ignore_patterns(
        "_local", "chiprun_out", "_build", ".git", "__pycache__", "tests",
        "robust_object_detection_tpu", "examples", "docs"))
    text = (ROOT / HEADER).read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"FAIL: cut {name}: its code is not in "
                             f"{HEADER} once")
        text = text.replace(old, new)
    (d / HEADER).write_text(text)
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dest", type=Path, default=Path(
        os.environ.get("TMPDIR", "/tmp")) / "front_cuts")
    ap.add_argument("--only", nargs="*", default=list(CUTS),
                    choices=list(CUTS))
    args = ap.parse_args()
    trees = [ROOT] + [make(args.dest, n) for n in args.only]
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=t)
             for t in trees]
    if any(p.wait() != 0 for p in procs):
        print("FAIL: a build failed", file=sys.stderr)
        return 1
    for t in trees:
        print(f"=== {t.name if t != ROOT else 'this checkout'}", flush=True)
        subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "profile_torch_front.py"),
                        "--dtype", "float32", "--root", str(t)], check=True)
    shutil.rmtree(args.dest, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
