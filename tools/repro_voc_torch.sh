#!/usr/bin/env bash
# One-command VOC reproduction on the PyTorch port (counterpart of
# tools/repro_voc.sh): train 20k -> in-training validation -> offline MS+CRF
# eval -> CAM inference -> test-set palette conversion, each stage through
# its _torch tool.
#
# Expected numbers (reference README.md:141, logs/dupl_train_voc/train.log):
#   in-training seg mIoU @20k : 69.0 / 69.9 (branch1 / branch2)
#   val mIoU single-scale     : 69.9
#   val mIoU MS+CRF           : 72.2   <- parity target
#
# Usage:
#   bash tools/repro_voc_torch.sh --data-folder /path/VOC2012 \
#       [--pretrained pretrained/deit_base_patch16_224.pth] [--work-dir DIR]
#   bash tools/repro_voc_torch.sh --dry-run   # synthetic data, tiny model, CPU
#
# Without --dry-run every stage runs on the CUDA card (the tools refuse to
# start without one).  The dry run exercises every stage end to end on the
# CPU (a synthetic tree from dupl_tpu_torch.data.voc.write_synthetic_voc ->
# train across all three curriculum phases -> offline eval with the device
# CRF -> CAM inference -> palette conversion) with the test_tiny backbone.

set -euo pipefail
cd "$(dirname "$0")/.."

DATA_FOLDER=""
PRETRAINED=""
WORK_DIR="work_dir/repro_voc_torch"
DRY_RUN=0

while [[ $# -gt 0 ]]; do
  case "$1" in
    --data-folder) DATA_FOLDER="$2"; shift 2 ;;
    --pretrained)  PRETRAINED="$2"; shift 2 ;;
    --work-dir)    WORK_DIR="$2"; shift 2 ;;
    --dry-run)     DRY_RUN=1; shift ;;
    *) echo "unknown arg: $1" >&2; exit 2 ;;
  esac
done

if [[ "$DRY_RUN" == 1 ]]; then
  WORK_DIR="${TMPDIR:-/tmp}/repro_voc_torch_dry"
  rm -rf "$WORK_DIR"; mkdir -p "$WORK_DIR"
  DATA_FOLDER="$WORK_DIR/fake_voc"
  # 8 train and 8 val scenes of 96 x 96, the size of the JAX dry run's tree
  python -c "from dupl_tpu_torch.data.voc import write_synthetic_voc as w; \
w('$DATA_FOLDER', [(96, 96)] * 8, train_sizes=[(96, 96)] * 8)"
  LIST_FOLDER="$DATA_FOLDER/lists"
  SMOKE=(--device cpu --backbone test_tiny_patch16 --crop-size 64)
  TRAIN_ARGS=(--max-iters 6 --cam-iters 2 --gmm-iters 4 --eval-iters 6
              --log-iters 1 --num-workers 2 "${SMOKE[@]}")
  EVAL_ARGS=(--max-images 4 --batch-size 2 "${SMOKE[@]}")
else
  [[ -n "$DATA_FOLDER" ]] || { echo "--data-folder required" >&2; exit 2; }
  LIST_FOLDER="datasets/voc"
  SMOKE=()
  TRAIN_ARGS=()
  EVAL_ARGS=()
  mkdir -p "$WORK_DIR"
fi

RUN_DIR="$WORK_DIR/run"
mkdir -p "$RUN_DIR"

echo "== [1/4] train (20k iters, 3-phase curriculum) =="
PRETRAIN_ARGS=()
[[ -n "$PRETRAINED" ]] && PRETRAIN_ARGS=(--pretrained "$PRETRAINED")
python tools/train_torch.py --dataset voc \
  --data-folder "$DATA_FOLDER" --list-folder "$LIST_FOLDER" \
  --work-dir "$RUN_DIR" --comment=_repro \
  "${PRETRAIN_ARGS[@]}" "${TRAIN_ARGS[@]}"

WEIGHTS=$(ls -t "$RUN_DIR"/*/checkpoints/weights.npz 2>/dev/null | head -1)
[[ -n "$WEIGHTS" ]] || { echo "no weights.npz produced" >&2; exit 1; }
echo "weights: $WEIGHTS"

echo "== [2/4] offline eval: multi-scale + flip + CRF =="
python tools/eval_seg_torch.py --dataset voc \
  --data-folder "$DATA_FOLDER" --list-folder "$LIST_FOLDER" \
  --weights "$WEIGHTS" --crf device --out-dir "$WORK_DIR/eval" \
  "${EVAL_ARGS[@]}"

echo "== [3/4] CAM inference (visual sanity) =="
python tools/infer_cam_torch.py \
  --data-folder "$DATA_FOLDER" --list-folder "$LIST_FOLDER" \
  --weights "$WEIGHTS" --out-dir "$WORK_DIR/cams" --max-images 4 \
  "${SMOKE[@]}"

echo "== [4/4] test-set palette conversion =="
python tools/convert_test_seg_torch.py --dir "$WORK_DIR/eval/seg_preds" \
  --target-dir "$WORK_DIR/seg_preds_palette"

echo
echo "Done.  Expected at full scale (reference README.md:141):"
echo "  val mIoU single-scale ~69.9 | MS+CRF ~72.2 (parity target)"
echo "Artifacts under $WORK_DIR"
