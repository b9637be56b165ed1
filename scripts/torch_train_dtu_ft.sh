#!/bin/bash
# DTU fine-tune launcher of the PyTorch port (counterpart of scripts/train_dtu_ft.sh,
# the same flags): runs neuraludf_tpu_torch.cli on the CUDA card; -g picks its index.
usage() { echo "Usage: ${0} [-c|--case] [-lr] [-lr_geo] [-g|--gpu]" 1>&2; exit 1; }
while [[ $# -gt 0 ]]; do
  case ${1} in
    -c|--case) CASE=${2}; shift 2;;
    -g|--gpu) GPU=${2}; shift 2;;
    -lr|--learning_rate) LR=${2}; shift 2;;
    -lr_geo|--learning_rate_geo) LR_GEO=${2}; shift 2;;
    *) usage; shift;;
  esac
done
python -m neuraludf_tpu_torch.cli --conf ./confs/udf_dtu_blending_ft.conf \
  --case ${CASE} --threshold 0.005 --resolution 128 --is_continue --is_finetune \
  ${LR:+--learning_rate ${LR}} ${LR_GEO:+--learning_rate_geo ${LR_GEO}} ${GPU:+--gpu ${GPU}}
