#!/usr/bin/env python3
"""Write tests/fixtures/jpeg/: small JPEG files made by Pillow, one for each
recipe below, and MANIFEST.json with each file's recipe, its SHA-256 and
the SHA-256 of the pixels Pillow decodes from it
(``Image.open(p).convert("RGB")``).

    python3 tools/make_jpeg_fixtures.py [OUT_DIR]

The files exercise what the port's decoder (native/jpeg.cc) must read:
baseline at several qualities and subsamplings, grey, progressive,
optimised Huffman tables, restart intervals and Adobe RGB. A machine
without Pillow (the card's) decodes them and holds the port's pixels to
the manifest's digests (chip_smoke.py phase 30);
tests/test_torch_jpeg.py checks on the CPU that the manifest is what this
script writes and that the files decode as Pillow and cv2 decode them.
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

# name: ((height, width), mode, Pillow's save keywords)
RECIPES = {
    "q75_420_33x65": ((33, 65), "RGB", {}),
    "q92_422_17x40": ((17, 40), "RGB", {"quality": 92, "subsampling": 1}),
    "q95_444_40x23": ((40, 23), "RGB", {"quality": 95, "subsampling": 0}),
    "q1_420_16x16": ((16, 16), "RGB", {"quality": 1}),
    "q100_420_15x17": ((15, 17), "RGB", {"quality": 100}),
    "q50_420_1x1": ((1, 1), "RGB", {"quality": 50}),
    "grey_q75_7x9": ((7, 9), "L", {}),
    "grey_progressive_31x45": ((31, 45), "L", {"progressive": True}),
    "progressive_420_48x64": ((48, 64), "RGB", {"progressive": True}),
    "progressive_444_q95_21x35": ((21, 35), "RGB",
                                  {"progressive": True, "subsampling": 0,
                                   "quality": 95}),
    "optimize_420_32x48": ((32, 48), "RGB", {"optimize": True}),
    "restart_rows_420_40x70": ((40, 70), "RGB", {"restart_marker_rows": 1}),
    "restart_blocks_progressive_24x40": ((24, 40), "RGB",
                                         {"restart_marker_blocks": 3,
                                          "progressive": True}),
    "adobe_rgb_444_19x29": ((19, 29), "RGB",
                            {"keep_rgb": True, "subsampling": 0}),
    "q95_420_120x160": ((120, 160), "RGB", {"quality": 95}),
}


def recipe_image(name: str, hw, mode: str) -> np.ndarray:
    """A smooth gradient with seeded noise (seed: the recipe's index), so
    that every block has AC content and the files stay small."""
    seed = list(RECIPES).index(name)
    h, w = hw
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(w + h - 2, 1)], -1)
    img = np.clip(base + rng.randint(-24, 25, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[:, :, 0] if mode == "L" else img


def make(name: str) -> bytes:
    from PIL import Image
    hw, mode, kw = RECIPES[name]
    buf = io.BytesIO()
    Image.fromarray(recipe_image(name, hw, mode)).save(buf, format="JPEG",
                                                       **kw)
    return buf.getvalue()


def pixel_digest(data: bytes) -> str:
    from PIL import Image
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def manifest() -> dict:
    out = {}
    for name, (hw, mode, kw) in RECIPES.items():
        data = make(name)
        out[name] = {"file": f"{name}.jpg", "height": hw[0],
                     "width": hw[1], "mode": mode, "save": kw,
                     "file_sha256": hashlib.sha256(data).hexdigest(),
                     "pixels_sha256": pixel_digest(data)}
    return out


def main(out_dir: Path) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in RECIPES:
        (out_dir / f"{name}.jpg").write_bytes(make(name))
    (out_dir / "MANIFEST.json").write_text(
        json.dumps(manifest(), indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out_dir.iterdir())
    print(f"{len(RECIPES)} fixtures, {total} bytes in {out_dir}")
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.exit(main(Path(sys.argv[1]) if len(sys.argv) > 1
                  else root / "tests" / "fixtures" / "jpeg"))
