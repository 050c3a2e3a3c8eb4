"""The launch plans of K3's bf16 tensor-core kernels
(robust_object_detection_tpu_torch/kernels: conv3x3_tc_plan, wgrad_tc_plan,
chunk_tiles), computed in Python and held here on the CPU:

  * every 8 x 16 pixel tile belongs to exactly one K3-b chunk and to
    exactly one persistent K3-f block, and each chunk walks as many tiles as
    the kernel's own count ((tiles - 1 - chunk) // n_chunks + 1);
  * the chunk count is fixed for a shape (and a card): it does not depend
    on the tensors' addresses, so a repeated run sums in the same order;
  * 16-byte staging is chosen only when both channel counts are multiples
    of 8 and both base pointers are 16-byte aligned;
  * shapes the kernels cannot take raise ValueError.
"""

import pytest

from robust_object_detection_tpu_torch import kernels as K

H100_SMS = 132
# (B, H, W, Cin, Cout): the model paths' shapes and the card tests' odd ones
SHAPES = [(16, 256, 256, 48, 48), (8, 256, 256, 48, 48), (2, 37, 45, 5, 20),
          (1, 9, 30, 3, 17), (2, 37, 45, 24, 56), (1, 1, 17, 40, 20),
          (2, 9, 17, 40, 56), (3, 16, 16, 8, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_belongs_to_one_chunk_and_one_block(shape):
    b, h, w, cin, cout = shape
    tiles = b * -(-h // K.TC_TH) * -(-w // K.TC_TW)
    assert K.tc_tiles(b, h, w) == tiles
    for plan, n in ((K.wgrad_tc_plan(*shape, (0, 0), H100_SMS), "n_chunks"),
                    (K.conv3x3_tc_plan(*shape, (0, 0), H100_SMS), "blocks")):
        assert plan["tiles"] == tiles and 1 <= plan[n] <= tiles
        owned = [t for c in range(plan[n])
                 for t in K.chunk_tiles(tiles, plan[n], c)]
        assert sorted(owned) == list(range(tiles))
        for c in range(plan[n]):
            assert len(K.chunk_tiles(tiles, plan[n], c)) == \
                (tiles - 1 - c) // plan[n] + 1


@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_count_is_fixed_for_a_shape(shape):
    plans = [K.wgrad_tc_plan(*shape, ptrs, H100_SMS)
             for ptrs in ((0, 0), (2, 0), (4096, 16 * 999), (0, 0))]
    assert len({p["n_chunks"] for p in plans}) == 1
    assert len({(p["mt"], p["nt"]) for p in plans}) == 1


def test_path_shapes_fill_the_card():
    """At the model paths' shapes: all 48 x 48 channels in one block (3 m16
    x 6 n8 tiles), 16-byte staging, two blocks an SM."""
    for batch in (16, 8):
        wg = K.wgrad_tc_plan(batch, 256, 256, 48, 48, (0, 256), H100_SMS)
        assert (wg["mt"], wg["nt"], wg["vec"]) == (3, 6, 1)
        assert wg["n_chunks"] == 2 * H100_SMS
        fw = K.conv3x3_tc_plan(batch, 256, 256, 48, 48, (0, 256), H100_SMS)
        assert (fw["nt"], fw["vec"], fw["co_chunks"]) == (6, 1, 1)
        assert fw["blocks"] == 2 * H100_SMS


@pytest.mark.parametrize("cin,cout,ptrs,vec", [
    (48, 48, (0, 16), 1), (24, 56, (32, 48), 1), (40, 8, (0, 0), 1),
    (48, 48, (2, 16), 0), (48, 48, (0, 8), 0), (5, 48, (0, 0), 0),
    (48, 20, (0, 0), 0), (3, 17, (0, 0), 0), (12, 16, (0, 0), 0)])
def test_16_byte_staging_only_where_allowed(cin, cout, ptrs, vec):
    assert K.wgrad_tc_plan(2, 9, 17, cin, cout, ptrs, H100_SMS)["vec"] == vec
    assert K.conv3x3_tc_plan(2, 9, 17, cin, cout, ptrs, H100_SMS)["vec"] \
        == vec


@pytest.mark.parametrize("cin,cout,mt,nt", [
    (3, 16, 1, 2), (16, 17, 1, 6), (17, 16, 3, 2), (48, 48, 3, 6),
    (56, 56, 3, 6)])
def test_channel_tiles(cin, cout, mt, nt):
    """Up to 16 channels take one m16 (K3-b) / two n8 tiles, more take
    48-channel slices; the grid covers every channel."""
    wg = K.wgrad_tc_plan(1, 8, 16, cin, cout, (0, 0), H100_SMS)
    assert (wg["mt"], wg["nt"]) == (mt, nt)
    fw = K.conv3x3_tc_plan(1, 8, 16, cin, cout, (0, 0), H100_SMS)
    assert fw["nt"] == (2 if cout <= 16 else 6)
    assert fw["co_chunks"] * 8 * fw["nt"] >= cout


@pytest.mark.parametrize("shape", [(0, 8, 8, 4, 4), (1, 0, 8, 4, 4),
                                   (1, 8, 8, 0, 4), (1, 8, 8, 4, 0)])
def test_plans_refuse_empty_shapes(shape):
    with pytest.raises(ValueError):
        K.conv3x3_tc_plan(*shape, (0, 0), H100_SMS)
    with pytest.raises(ValueError):
        K.wgrad_tc_plan(*shape, (0, 0), H100_SMS)
