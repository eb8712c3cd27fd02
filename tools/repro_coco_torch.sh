#!/usr/bin/env bash
# One-command COCO reproduction on the PyTorch port (counterpart of
# tools/repro_coco.sh): train 80k (4-phase curriculum incl. the 12k
# aux->main refine-source switch) -> in-training validation -> offline
# fixed-crop sum-merge eval with CRF -> test-set palette conversion, each
# stage through its _torch tool.
#
# Expected numbers (reference README.md:143, logs/dupl_train_coco/train.log):
#   in-training seg mIoU @80k : 42.27 / 42.31 (branch1 / branch2)
#   val mIoU MS+CRF           : 43.5   <- parity target
#
# Usage:
#   bash tools/repro_coco_torch.sh --data-folder /path/MSCOCO/coco2014 \
#       [--pretrained pretrained/deit_base_patch16_224.pth] [--work-dir DIR]
#   bash tools/repro_coco_torch.sh --dry-run  # synthetic data, tiny model, CPU
#
# Without --dry-run every stage runs on the CUDA card (the tools refuse to
# start without one).  The dry run exercises every stage end to end on the
# CPU (a COCO-layout tree from dupl_tpu_torch.data.coco.write_synthetic_coco,
# one grayscale jpeg included -> train across ALL FOUR curriculum phases ->
# sharded offline eval with the device CRF -> palette conversion) with the
# test_tiny backbone.

set -euo pipefail
cd "$(dirname "$0")/.."

DATA_FOLDER=""
PRETRAINED=""
WORK_DIR="work_dir/repro_coco_torch"
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
  WORK_DIR="${TMPDIR:-/tmp}/repro_coco_torch_dry"
  rm -rf "$WORK_DIR"; mkdir -p "$WORK_DIR"
  # 8 train and 3 val scenes of 96 x 96, the size of the JAX dry run's tree
  python -c "from dupl_tpu_torch.data.coco import write_synthetic_coco as w; \
w('$WORK_DIR/fake', [(96, 96)] * 3, [(96, 96)] * 8)"
  DATA_FOLDER="$WORK_DIR/fake/coco2014"
  LIST_FOLDER="$WORK_DIR/fake/lists"
  SMOKE=(--device cpu --backbone test_tiny_patch16 --crop-size 64)
  # 4 phases: warmup [0,2) / seg_static [2,4) / seg [4,6) / full [6,8)
  TRAIN_ARGS=(--max-iters 8 --cam-iters 2 --refine-switch-iters 4
              --gmm-iters 6 --eval-iters 8 --log-iters 2 --num-workers 2
              --samples-per-device 1 "${SMOKE[@]}")
  EVAL_ARGS=(--max-images 3 --batch-size 1 "${SMOKE[@]}")
else
  [[ -n "$DATA_FOLDER" ]] || { echo "--data-folder required" >&2; exit 2; }
  LIST_FOLDER="datasets/coco"
  SMOKE=()
  TRAIN_ARGS=()
  EVAL_ARGS=()
  mkdir -p "$WORK_DIR"
fi

RUN_DIR="$WORK_DIR/run"
mkdir -p "$RUN_DIR"

echo "== [1/3] train (80k iters, 4-phase curriculum) =="
PRETRAIN_ARGS=()
[[ -n "$PRETRAINED" ]] && PRETRAIN_ARGS=(--pretrained "$PRETRAINED")
python tools/train_torch.py --dataset coco \
  --data-folder "$DATA_FOLDER" --list-folder "$LIST_FOLDER" \
  --work-dir "$RUN_DIR" --comment=_repro \
  "${PRETRAIN_ARGS[@]}" "${TRAIN_ARGS[@]}"

WEIGHTS=$(ls -t "$RUN_DIR"/*/checkpoints/weights.npz 2>/dev/null | head -1)
[[ -n "$WEIGHTS" ]] || { echo "no weights.npz produced" >&2; exit 1; }
echo "weights: $WEIGHTS"

echo "== [2/3] offline eval: fixed-crop sum-merge + flip + CRF (sharded like the reference's DDP evaluation) =="
python tools/eval_seg_torch.py --dataset coco \
  --data-folder "$DATA_FOLDER" --list-folder "$LIST_FOLDER" \
  --weights "$WEIGHTS" --crf device --out-dir "$WORK_DIR/eval" \
  --shard 0 --num-shards 1 \
  "${EVAL_ARGS[@]}"

echo "== [3/3] palette conversion =="
python tools/convert_test_seg_torch.py --dir "$WORK_DIR/eval/seg_preds" \
  --target-dir "$WORK_DIR/seg_preds_palette"

echo
echo "Done.  Expected at full scale (reference README.md:143):"
echo "  val mIoU MS+CRF ~43.5 (parity target)"
echo "Artifacts under $WORK_DIR"
