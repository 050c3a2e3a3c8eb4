#!/bin/bash
# Mutation runs of chip_smoke.py's checks on the card: each mutation in its
# own copy of the tree (the kernels built once, before the copies), running
# only the phase that must catch it through tools/smoke_phases.py. Prints
# one line a mutation with its exit code (1 expected) and the first FAIL;
# each run's log goes to LOG_DIR/mut_<name>.log (default _local/mutants).
#
#     bash tools/smoke_mutants.sh [LOG_DIR]
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd)
cd "$ROOT"
LOG_DIR=$(mkdir -p "${1:-_local/mutants}" && cd "${1:-_local/mutants}" && pwd)
python3 -c "from robust_object_detection_tpu_torch import kernels; kernels.build()"

mutate () {   # name file old new phase
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
