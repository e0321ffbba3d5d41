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
for src in "${sources[@]}"; do
  "${nvcc[@]}" -Xptxas -v -c -o "$out/$(basename "$src").o" "$src" 2>&1 |
    grep -E "Compiling entry|Used|spill|warning|Potential" | sed 's/ptxas info    : //' &
done
wait
