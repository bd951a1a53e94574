#!/usr/bin/env bash
# Single-host fine-tune on the PyTorch port (reference single_node_train_medsam2.sh
# equivalent): torchrun starts one trainer process a visible GPU, and the
# processes form one data-parallel NCCL group (parallel/distributed.py).
#
#   scripts/torch_train_single_host.sh DATA_DIR OUT_DIR [INIT_CKPT] [TRAINER ARGS...]
#
# Trainer arguments after the third positional one follow the recipe's and
# override it (pass "" as INIT_CKPT to start from the config's own weights).
# NPROC_PER_NODE overrides the count of visible GPUs; PYTHON the interpreter.
# torchrun is used when it is on PATH, else `$PYTHON -m torch.distributed.run`.
# The trainer is exec'd, so SIGTERM reaches it and it checkpoints before exiting.
set -euo pipefail
DATA_DIR=${1:?usage: torch_train_single_host.sh DATA_DIR OUT_DIR [INIT_CKPT] [TRAINER ARGS...]}
OUT_DIR=${2:?}
INIT_CKPT=${3:-}
shift $(( $# < 3 ? $# : 3 ))
PYTHON=${PYTHON:-python}
NPROC=${NPROC_PER_NODE:-$("$PYTHON" -c 'import torch; print(torch.cuda.device_count())')}
if [ "$NPROC" -lt 1 ]; then
    echo "torch_train_single_host.sh: no visible GPU (set NPROC_PER_NODE and pass --device cpu to train on the CPU)" >&2
    exit 1
fi
ARGS=(--data_dir "$DATA_DIR" --out_dir "$OUT_DIR" --epochs 100 --num_frames 4 \
      --max_num_objects 5 --curriculum quantum --temporal_loss consistency)
if [ -n "$INIT_CKPT" ]; then ARGS+=(--init_ckpt "$INIT_CKPT"); fi
if command -v torchrun >/dev/null 2>&1; then RUN=(torchrun); else RUN=("$PYTHON" -m torch.distributed.run); fi
exec "${RUN[@]}" --standalone --nproc_per_node="$NPROC" \
    -m us_video_medsam2_tpu_torch.apps.train "${ARGS[@]}" "$@"
