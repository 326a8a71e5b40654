#!/usr/bin/env bash
# A/B of patch attention's times (pcd_reg_hregnet_torch/time_attention.py)
# between a parent commit and this checkout on one card, in the order parent,
# change, change, parent; each run is a fresh process that builds its own
# tree's kernels first.
#
#   tools/ab_time_attention.sh PARENT_DIR [time_attention arguments]
#
# PARENT_DIR holds the parent commit (`git archive`), e.g. unpacked into the
# git-ignored chiprun_tree/parent; it is only read.  Its package is copied
# into a temporary directory (under $TMPDIR), where it gets this checkout's
# time_attention.py, which calls only public functions, so both sides are
# timed the same way.  Example, the bf16 backward:
#   tools/ab_time_attention.sh chiprun_tree/parent --backward --dtypes bfloat16
set -euo pipefail
parent=$(cd "$1" && pwd)
shift
here=$(cd "$(dirname "$0")/.." && pwd)
copy=$(mktemp -d "${TMPDIR:-/tmp}/ab_time_attention.XXXXXX")
trap 'rm -rf "$copy"' EXIT
tar -C "$parent" --exclude=_build --exclude=__pycache__ -cf - pcd_reg_hregnet_torch \
  | tar -C "$copy" -xf -
cp "$here/pcd_reg_hregnet_torch/time_attention.py" "$copy/pcd_reg_hregnet_torch/"
for side in parent change change parent; do
  dir=$here
  if [ "$side" = parent ]; then dir=$copy; fi
  echo "== $side"
  (cd "$dir" && python3 -m pcd_reg_hregnet_torch.time_attention "$@")
done
