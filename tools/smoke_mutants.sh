#!/bin/bash
# Mutation runs of chip_smoke.py's checks on the card: each mutation in its
# own copy of the tree (the kernels built once, before the copies), running
# only the phase that must catch it through tools/smoke_phases.py. Prints
# one line a mutation with its exit code (1 expected) and the first FAIL;
# each run's log goes to LOG_DIR/mut_<name>.log (default _local/mutants).
#
#     bash tools/smoke_mutants.sh [LOG_DIR]
#
# ONLY="name ..." runs just the named mutations.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
cd "$ROOT"
LOG_DIR=$(mkdir -p "${1:-_local/mutants}" && cd "${1:-_local/mutants}" && pwd)
python3 -c "from robust_object_detection_tpu_torch import kernels; kernels.build()"

mutate () {   # name file old new phase
  if [ -n "${ONLY:-}" ] && [[ " $ONLY " != *" $1 "* ]]; then return; fi
  local dir="${TMPDIR:-/tmp}/mut_$1"
  rm -rf "$dir"; cp -r "$ROOT" "$dir"
  python3 - "$dir/$2" "$3" "$4" <<'PY'
import sys
p, old, new = sys.argv[1:4]
s = open(p).read()
assert old in s, (p, old)
open(p, "w").write(s.replace(old, new, 1))
PY
  (cd "$dir" && timeout 900 python3 tools/smoke_phases.py "$5" \
     > "$LOG_DIR/mut_$1.log" 2>&1)
  local rc=$?
  echo "MUTANT $1 exit $rc :: $(grep -m1 -o 'RuntimeError: FAIL: .*' \
    "$LOG_DIR/mut_$1.log" | cut -c1-300)"
  rm -rf "$dir"
}

# resize_linear_u8 with float64 coordinates: the golden cv2 digests
mutate resize_f64 robust_object_detection_tpu_torch/data/imageio.py \
  "         - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)" \
  "         - 0.5)
    s = np.floor(f)
    f = (f - s)" phase_cli
# --augment dropped by the CLI: K1 launches of the Augmented YOLO steps
mutate augment_dropped robust_object_detection_tpu_torch/cli.py \
  "augment=args.augment, variant=args.variant" \
  "augment=False, variant=args.variant" phase_cli
# eval-restored on the unrestored layout: the files it reads
mutate restored_layout robust_object_detection_tpu_torch/cli.py \
  'args.layout = (args.layout if args.layout.endswith("_restored")
                   else args.layout + "_restored")' \
  'args.layout = args.layout' phase_cli
# TF32 forced in the U-Net's convs: phase 19's patch-256 witness
mutate unet_tf32 robust_object_detection_tpu_torch/models/unet.py \
  "        inp = x.float()
        h = inp.permute(0, 3, 1, 2)" \
  "        torch.backends.cudnn.allow_tf32 = True
        inp = x.float()
        h = inp.permute(0, 3, 1, 2)" phase_unet_training
# ResNet's train-mode BatchNorm output left in the compute dtype (bf16):
# phase 28's dtype audit
mutate frcnn_bn_bf16 robust_object_detection_tpu_torch/models/resnet.py \
  "return bn_train(y, bn, torch.float32, BN_MOMENTUM)" \
  "return bn_train(y, bn, y.dtype, BN_MOMENTUM)" phase_frcnn_bf16
# the class logits computed in bf16 (flax promotes them to f32): phase 28
mutate frcnn_predictor_bf16 robust_object_detection_tpu_torch/models/frcnn.py \
  "        scores = self.box_predictor.cls_score(x)" \
  "        scores = linear(x, self.box_predictor.cls_score, self.dtype).float()" \
  phase_frcnn_bf16
# a data-parallel YOLO step without the gradient all-reduce: phase 29
mutate dp_no_grad_reduce robust_object_detection_tpu_torch/train/detector.py \
  "        mesh_lib.all_reduce_grads(model.parameters(), mesh)" \
  "        pass" phase_parallel
# train-mode BatchNorm statistics over each rank's rows only: phase 29
mutate dp_no_bn_reduce robust_object_detection_tpu_torch/parallel/mesh.py \
  "    ctx = _ACTIVE
    if ctx is None:
        return mean, meansq" \
  "    ctx = _ACTIVE
    if True:
        return mean, meansq" phase_parallel
# an islow IDCT constant off by one (it is the FDCT's too): phase 30 (a),
# the fixtures' decoded pixels against Pillow's digests
mutate idct_constant robust_object_detection_tpu_torch/native/jpeg.cc \
  "constexpr int32_t FIX_1_175875602 = 9633;" \
  "constexpr int32_t FIX_1_175875602 = 9634;" phase_codec
# the Annex K luminance table's DC entry 16 -> 17 (8 -> 9 at q 75): phase
# 30 (b), the encoder's bytes against Pillow's
mutate quant_entry robust_object_detection_tpu_torch/native/jpeg.cc \
  "    16, 11, 10, 16, 24,  40,  51,  61," \
  "    17, 11, 10, 16, 24,  40,  51,  61," phase_codec
# the route sends angle 0 to the op-by-op ops: phase 31 (a), K1's count
mutate route_no_k1 robust_object_detection_tpu_torch/ops/corrupt.py \
  "    if k1_computes(cfg, h, w):" \
  "    if False:" phase_corrupt_route
# the op-by-op noise drawn for seed + 1: phase 31 (b), its noise images
# against K1's for the same seeds
mutate route_seed_offset robust_object_detection_tpu_torch/ops/corrupt.py \
  "                seed_list[i], part.shape[1:], x.device) for i in rows])" \
  "                seed_list[i] + 1, part.shape[1:], x.device) for i in rows])" \
  phase_corrupt_route
# RT-DETR-L's model ranks without the broadcast of the replicated leaves'
# gradients from model index 0: phase 29's bit-equality of the model ranks
mutate tp_no_grad_broadcast robust_object_detection_tpu_torch/train/rtdetr.py \
  "        mesh_lib.broadcast_over_model(replicated_grads(state), mesh)" \
  "        pass" phase_parallel
# each model rank reading its own matching: phase 29's bit-equality of the
# model ranks (the perturbed run's swapped queries)
mutate tp_no_match_broadcast robust_object_detection_tpu_torch/train/rtdetr.py \
  "        mesh_lib.broadcast_over_model([gt_for_query, capped], ctx)" \
  "        pass" phase_parallel
# K2's tensor-core train forward without the data-parallel statistics
# callback (BN1 / BN2 over each rank's rows): phase 29's bf16 YOLOv8m
# front statistics
mutate k2_tc_no_sync robust_object_detection_tpu_torch/ops/yolo_front.py \
  '                    *args, p1, p2, plan["p1"]["vec"], plan["p2"]["vec"],
                    sync, sync_buf.data_ptr(), stream)' \
  '                    *args, p1, p2, plan["p1"]["vec"], plan["p2"]["vec"],
                    None, sync_buf.data_ptr(), stream)' phase_parallel
# K3's f32 route in one pass of TF32 (the two correction products dropped):
# phase 3's f32 K3-f at 1e-4 x max|ref| (one pass sits near 3e-4)
mutate k3_f32_one_pass robust_object_detection_tpu_torch/csrc/conv3x3_tf32.cuh \
  "constexpr int SPLIT_PASSES = 3;" "constexpr int SPLIT_PASSES = 1;" \
  phase_kernels
# the split without its guard (lo = tf32(Inf - Inf) = NaN): phase 3's f32
# K3-f on an Inf input against float64
mutate k3_f32_no_inf_guard robust_object_detection_tpu_torch/csrc/conv3x3_tf32.cuh \
  "  hi = finite ? h : 0u;
  lo = finite ? (__float_as_uint(l) + 0x1000u) & 0xffffe000u
              : __float_as_uint(a);" \
  "  hi = h;
  lo = (__float_as_uint(l) + 0x1000u) & 0xffffe000u;" phase_kernels
# K3-b's f32 kernel alone in one pass of TF32 (the staged x and dy split
# with lo = 0; K3-f untouched): phase 6's f32 K3-b at 1.5e-4 x max|ref|
# (one pass sits near 2.6e-4)
mutate k3b_f32_no_lo robust_object_detection_tpu_torch/csrc/conv3x3_tf32.cuh \
  "make_uint4(h0, h1, l0, l1);" "make_uint4(h0, h1, 0u, 0u);" \
  phase_train_kernels
# K2's f32 forward in one pass of TF32 (P1 and P2 without the two
# correction products): phase 3's f32 K2-f at 1e-4 x max|ref| (one pass
# sits near 4.5e-4 in tests/test_torch_front_tf32.py's emulation)
mutate k2_f32_one_pass robust_object_detection_tpu_torch/csrc/front_tf32.cuh \
  "constexpr int FWD_PASSES = 3;" "constexpr int FWD_PASSES = 1;" \
  phase_kernels
# K2-b's filter gradients dk2 and dk1 in one pass of TF32 (their staged
# operands split with lo = 0; dA1 untouched): phase 6's f32 K2-b bar
mutate k2b_f32_no_lo robust_object_detection_tpu_torch/csrc/front_tf32.cuh \
  "  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);" \
  "  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, 0u, 0u);" \
  phase_train_kernels
# K4's f32 forward in one pass of TF32 (stem1, the 2x2 convs and stem3
# without the two correction products): phase 9's f32 K4-f y3 at 1e-4 x
# max|ref| (one pass sits near 6e-4 in tests/test_torch_stem_tf32.py's
# emulation)
mutate k4_f32_one_pass robust_object_detection_tpu_torch/csrc/front_tf32.cuh \
  "constexpr int FWD_PASSES = 3;" "constexpr int FWD_PASSES = 1;" \
  phase_rtdetr_kernels
# K4-b's filter gradients (dk3, dk2b, dk2a, dk1) in one pass of TF32 (their
# staged operands split with lo = 0): phase 12's f32 K4-b bar
mutate k4b_f32_no_lo robust_object_detection_tpu_torch/csrc/front_tf32.cuh \
  "  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);" \
  "  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, 0u, 0u);" \
  phase_rtdetr_train_kernels
# the walk's IoU denominator contracted into an FMA ((ka + ca) - iw * ih in
# one rounding): phase 33's IoUs an ulp around the threshold
mutate nms_fma robust_object_detection_tpu_torch/csrc/nms.cu \
  "  const T den = clamp_lo(sub_rn(add_rn(ka, ca), inter), den_floor<T>());" \
  "  const T den = clamp_lo(fma(-iw, ih, add_rn(ka, ca)), den_floor<T>());" \
  phase_nms
