#!/usr/bin/env bash
# Print each kernel's registers, shared memory and spills as ptxas reports
# them (nvcc -Xptxas -v), and every ptxas warning or performance note (a
# setmaxnreg it ignored, wgmma it serialized), with the nvcc and flags that
# marqo_tpu_torch/ops/_build.py builds the library with.
#   scripts/ptxas_report.sh [source.cu ...]   (default: every csrc/*.cu)
set -euo pipefail
cd "$(dirname "$0")/.."
command=$(python3 -c 'from marqo_tpu_torch.ops import _build
print("\n".join([_build._nvcc(), *_build.NVCC_FLAGS]))')
mapfile -t nvcc <<< "$command"
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
sources=("$@")
[ ${#sources[@]} -eq 0 ] && sources=(marqo_tpu_torch/csrc/*.cu)
# one nvcc per source, all at once; each report is printed whole once its
# compile is done, so a kernel's lines never interleave with another's
for src in "${sources[@]}"; do
  name=$(basename "$src")
  "${nvcc[@]}" -Xptxas -v -c -o "$out/$name.o" "$src" > "$out/$name.txt" 2>&1 &
done
wait
for src in "${sources[@]}"; do
  grep -E "Compiling entry|Used|spill|warning|Potential" "$out/$(basename "$src").txt" |
    sed 's/ptxas info    : //'
done
