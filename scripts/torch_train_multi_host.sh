#!/usr/bin/env bash
# Multi-host training on the PyTorch port (reference multi_node_train.sh
# equivalent). Run this same script on every host: torchrun starts one trainer
# process a visible GPU, and the hosts meet at MASTER_ADDR:MASTER_PORT.
#
#   NNODES=N NODE_RANK=i MASTER_ADDR=host0 [MASTER_PORT=29500] \
#       scripts/torch_train_multi_host.sh DATA_DIR OUT_DIR [INIT_CKPT] [TRAINER ARGS...]
#
# Trainer arguments after the third positional one follow the recipe's and
# override it. NPROC_PER_NODE overrides the count of visible GPUs; PYTHON the
# interpreter. torchrun is used when it is on PATH, else
# `$PYTHON -m torch.distributed.run`. The trainer is exec'd, so SIGTERM
# reaches it and it checkpoints before exiting.
set -euo pipefail
DATA_DIR=${1:?usage: torch_train_multi_host.sh DATA_DIR OUT_DIR [INIT_CKPT] [TRAINER ARGS...]}
OUT_DIR=${2:?}
INIT_CKPT=${3:-}
shift $(( $# < 3 ? $# : 3 ))
NNODES=${NNODES:?set NNODES, the number of hosts}
NODE_RANK=${NODE_RANK:?set NODE_RANK, the rank of this host (0 on MASTER_ADDR)}
MASTER_ADDR=${MASTER_ADDR:?set MASTER_ADDR, the address of the host of rank 0}
MASTER_PORT=${MASTER_PORT:-29500}
PYTHON=${PYTHON:-python}
NPROC=${NPROC_PER_NODE:-$("$PYTHON" -c 'import torch; print(torch.cuda.device_count())')}
if [ "$NPROC" -lt 1 ]; then
    echo "torch_train_multi_host.sh: no visible GPU (set NPROC_PER_NODE and pass --device cpu to train on the CPU)" >&2
    exit 1
fi
ARGS=(--data_dir "$DATA_DIR" --out_dir "$OUT_DIR" --epochs 100 --num_frames 4 \
      --max_num_objects 5 --curriculum quantum --temporal_loss consistency)
if [ -n "$INIT_CKPT" ]; then ARGS+=(--init_ckpt "$INIT_CKPT"); fi
if command -v torchrun >/dev/null 2>&1; then RUN=(torchrun); else RUN=("$PYTHON" -m torch.distributed.run); fi
exec "${RUN[@]}" --nnodes="$NNODES" --node_rank="$NODE_RANK" --nproc_per_node="$NPROC" \
    --master_addr="$MASTER_ADDR" --master_port="$MASTER_PORT" \
    -m us_video_medsam2_tpu_torch.apps.train "${ARGS[@]}" "$@"
