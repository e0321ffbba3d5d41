"""The routed experts' share of their roofline: for each add completed in
the window, the larger of the routed experts' operations over its
acknowledged documents' real tokens (at 989 TFLOP/s) and every routed
expert's weights read once (at 3.35 TB/s), summed, over the device time of
the grouped-GEMM kernels in the trace (matched by name). The shared
experts run as a dense SwiGLU on cuBLAS, whose kernels no name tells from
the attention projections', so they are left out of both sides. Pad
tokens count no work, so routing them would show as lost share. No
matching kernel is an error."""

import re

from reference.bounds import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

# torch._grouped_mm's launches on sm90: its data preparation and the
# CUTLASS grouped GEMM (a GemmUniversal over a GroupProblemShape)
KERNELS = re.compile(r"GroupProblemShape|prepare_grouped_gemm_data")


def read(window):
    trace = window.trace
    if trace is None or not trace.device_ops:
        return None
    kernel_s = sum(s for name, s in trace.seconds_by_name().items()
                   if KERNELS.search(name))
    if not kernel_s:
        raise RuntimeError("no grouped-GEMM kernel in the trace")
    reference = window.reference()
    fields = window.traffic["tensor_fields"]
    weights_s = reference.expert_weight_bytes() / PEAK_BYTES_PER_S
    bound_s = 0.0
    for r in window.in_window():
        _client, _sent, _done, first, n, status, failed, _t = r
        if status != 200:
            continue
        bad = set(failed)
        ops = sum(reference.expert_work(window.document(first + j), fields)
                  for j in range(n) if j not in bad)
        bound_s += max(ops / PEAK_BF16_FLOPS, weights_s)
    return 100.0 * bound_s / kernel_s
