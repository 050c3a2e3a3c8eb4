"""The launch plans of K3's tensor-core kernels
(robust_object_detection_tpu_torch/kernels: conv3x3_tc_plan, wgrad_tc_plan
for each dtype, bf16 and f32 (split TF32), and chunk_tiles), computed in
Python and held here on the CPU:

  * every pixel tile belongs to exactly one K3-b chunk and to exactly one
    persistent K3-f block, and each chunk walks as many tiles as the
    kernel's own count ((tiles - 1 - chunk) // n_chunks + 1); K3-b walks
    8 x 16 tiles, K3-f 8 x 16 (bf16) or 16 x 16 (f32);
  * the chunk count is fixed for a shape (and a card): it does not depend
    on the tensors' addresses, so a repeated run sums in the same order;
  * 16-byte staging is chosen only when the staged channel counts are
    multiples of 8 (bf16) or 4 (f32) and the staged base pointers 16-byte
    aligned (the f32 K3-f stages only x by cp.async);
  * shapes the kernels cannot take raise ValueError.
"""

import pytest

from robust_object_detection_tpu_torch import kernels as K

H100_SMS = 132
DTYPES = ["bfloat16", "float32"]
# (B, H, W, Cin, Cout): the model paths' shapes and the card tests' odd ones
SHAPES = [(16, 256, 256, 48, 48), (8, 256, 256, 48, 48), (2, 37, 45, 5, 20),
          (1, 9, 30, 3, 17), (2, 37, 45, 24, 56), (1, 1, 17, 40, 20),
          (2, 9, 17, 40, 56), (3, 16, 16, 8, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_belongs_to_one_chunk_and_one_block(shape, dtype):
    b, h, w, cin, cout = shape
    th = {"bfloat16": 8, "float32": 16}[dtype]
    assert K.tc_tiles(b, h, w) == b * -(-h // 8) * -(-w // 16)
    wg = K.wgrad_tc_plan(dtype, *shape, (0, 0), H100_SMS)
    fw = K.conv3x3_tc_plan(dtype, *shape, (0, 0), H100_SMS)
    assert wg["tiles"] == K.tc_tiles(b, h, w)
    assert fw["tiles"] == b * -(-h // th) * -(-w // 16)
    for plan, n in ((wg, "n_chunks"), (fw, "blocks")):
        tiles = plan["tiles"]
        assert 1 <= plan[n] <= tiles
        owned = [t for c in range(plan[n])
                 for t in K.chunk_tiles(tiles, plan[n], c)]
        assert sorted(owned) == list(range(tiles))
        for c in range(plan[n]):
            assert len(K.chunk_tiles(tiles, plan[n], c)) == \
                (tiles - 1 - c) // plan[n] + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_count_is_fixed_for_a_shape(shape, dtype):
    ptrs = ((0, 0), (4, 0), (4096, 16 * 999), (0, 0))
    plans = [K.wgrad_tc_plan(dtype, *shape, p, H100_SMS) for p in ptrs]
    assert len({(p["n_chunks"], p["mt"], p["nt"]) for p in plans}) == 1
    blocks = {K.conv3x3_tc_plan(dtype, *shape, p, H100_SMS)["blocks"]
              for p in ptrs}
    assert len(blocks) == 1


@pytest.mark.parametrize("dtype,per_sm,tiles_per_img", [
    ("bfloat16", 2, 32 * 16), ("float32", 1, 16 * 16)])
def test_path_shapes_fill_the_card(dtype, per_sm, tiles_per_img):
    """At the model paths' shapes: all 48 x 48 channels in one block (3 m16
    x 6 n8 tiles), 16-byte staging, two blocks an SM at bf16 and one at
    f32 (the f32 stages fill its shared memory)."""
    for batch in (16, 8):
        wg = K.wgrad_tc_plan(dtype, batch, 256, 256, 48, 48, (0, 256),
                             H100_SMS)
        assert (wg["mt"], wg["nt"], wg["vec"]) == (3, 6, 1)
        assert wg["n_chunks"] == per_sm * H100_SMS
        fw = K.conv3x3_tc_plan(dtype, batch, 256, 256, 48, 48, (0, 256),
                               H100_SMS)
        assert (fw["nt"], fw["vec"], fw["co_chunks"]) == (6, 1, 1)
        assert fw["blocks"] == per_sm * H100_SMS
        assert fw["tiles"] == batch * tiles_per_img


@pytest.mark.parametrize("dtype,cin,cout,ptrs,vec", [
    ("bfloat16", 48, 48, (0, 16), 1), ("bfloat16", 24, 56, (32, 48), 1),
    ("bfloat16", 40, 8, (0, 0), 1), ("bfloat16", 48, 48, (2, 16), 0),
    ("bfloat16", 48, 48, (0, 8), 0), ("bfloat16", 5, 48, (0, 0), 0),
    ("bfloat16", 48, 20, (0, 0), 0), ("bfloat16", 3, 17, (0, 0), 0),
    ("bfloat16", 12, 16, (0, 0), 0),
    ("float32", 48, 48, (0, 16), 1), ("float32", 24, 56, (32, 48), 1),
    ("float32", 4, 8, (0, 0), 1), ("float32", 12, 20, (0, 0), 1),
    ("float32", 48, 48, (4, 16), 0), ("float32", 48, 48, (0, 8), 0),
    ("float32", 5, 48, (0, 0), 0), ("float32", 48, 6, (0, 0), 0),
    ("float32", 3, 17, (0, 0), 0)])
def test_16_byte_staging_only_where_allowed(dtype, cin, cout, ptrs, vec):
    """K3-b stages x and dy by 16-byte pieces (8 bf16 or 4 f32 channels);
    K3-f at bf16 stages x and the filter, at f32 only x (its filter goes in
    transposed, element by element), so there the filter's pointer and
    Cout do not matter."""
    assert K.wgrad_tc_plan(dtype, 2, 9, 17, cin, cout, ptrs,
                           H100_SMS)["vec"] == vec
    fw = K.conv3x3_tc_plan(dtype, 2, 9, 17, cin, cout, ptrs, H100_SMS)
    if dtype == "bfloat16":
        assert fw["vec"] == vec
    else:
        assert fw["vec"] == int(cin % 4 == 0 and ptrs[0] % 16 == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout,mt,nt", [
    (3, 16, 1, 2), (16, 17, 1, 6), (17, 16, 3, 2), (48, 48, 3, 6),
    (56, 56, 3, 6)])
def test_channel_tiles(cin, cout, mt, nt, dtype):
    """Up to 16 channels take one m16 (K3-b) / two n8 tiles, more take
    48-channel slices; the grid covers every channel."""
    wg = K.wgrad_tc_plan(dtype, 1, 8, 16, cin, cout, (0, 0), H100_SMS)
    assert (wg["mt"], wg["nt"]) == (mt, nt)
    fw = K.conv3x3_tc_plan(dtype, 1, 8, 16, cin, cout, (0, 0), H100_SMS)
    assert fw["nt"] == (2 if cout <= 16 else 6)
    assert fw["co_chunks"] * 8 * fw["nt"] >= cout


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(0, 8, 8, 4, 4), (1, 0, 8, 4, 4),
                                   (1, 8, 0, 4, 4), (1, 8, 8, 0, 4),
                                   (1, 8, 8, 4, 0)])
def test_plans_refuse_empty_shapes(shape, dtype):
    with pytest.raises(ValueError):
        K.conv3x3_tc_plan(dtype, *shape, (0, 0), H100_SMS)
    with pytest.raises(ValueError):
        K.wgrad_tc_plan(dtype, *shape, (0, 0), H100_SMS)
