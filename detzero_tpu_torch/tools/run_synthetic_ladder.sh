#!/bin/bash
# The synthetic quality ladder in one command (port of
# tools/run_synthetic_ladder.sh):
#   1. dump refining records from tracked detections on TRAIN-seed scenes
#   2. train per-class GRM / PRM / CRM (one model a class, as the
#      reference), relabelling CRM's IoU targets between PRM and CRM
#   3. run the 4-stage ladder on HELD-OUT scenes and append the table to
#      $OUT_MD
# The steps are `ladder_synthetic.run_recipe`, which runs each of them
# through `ladder_synthetic.main` and `train_refine.main` and logs each
# step's wall seconds.  A class whose tracks cannot fill one batch, or that
# has none, is logged and keeps its unrefined boxes.
#
# Usage: detzero_tpu_torch/tools/run_synthetic_ladder.sh <det_ckpt_dir> \
#            [<det_cfg>] [<workdir>]
# The detector comes from
#   python -m detzero_tpu_torch.tools.train_det \
#       --cfg_file configs/det_model_cfgs/centerpoint_synthetic_v3.yaml \
#       --max_steps S
# Every stage runs on $DEVICE (the card by default; DEVICE=cpu runs the
# plain versions).
set -eo pipefail
CKPT=${1:?usage: run_synthetic_ladder.sh <det_ckpt_dir> [cfg] [workdir]}
CFG=${2:-configs/det_model_cfgs/centerpoint_synthetic_big.yaml}
WORK=${3:-output/ladder}
TRAIN_SEQ=${TRAIN_SEQ:-24}
VAL_SEQ=${VAL_SEQ:-8}
REFINE_STEPS=${REFINE_STEPS:-1500}
DET_BATCH=${DET_BATCH:-4}
DEVICE=${DEVICE:-cuda}
OUT_MD=${OUT_MD:-LADDER_TORCH.md}
cd "$(dirname "$0")/../.."
if command -v nvidia-smi >/dev/null; then
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
fi
python -m detzero_tpu_torch.tools.ladder_synthetic --recipe "$WORK" \
    --cfg_file "$CFG" --ckpt "$CKPT" --device "$DEVICE" \
    --batch_size "$DET_BATCH" --train_n_seq "$TRAIN_SEQ" --n_seq "$VAL_SEQ" \
    --refine_steps "$REFINE_STEPS" --train_seed 0 --val_seed 1234 \
    --out_md "$OUT_MD"
echo "ladder table appended to $OUT_MD"
