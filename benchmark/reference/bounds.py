"""The yardstick's arithmetic: the card's published peaks and the least
time a piece of work could take on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989 TFLOP/s in bf16, 1,979 TOP/s in int8, 3.35 TB/s of HBM.
``bound`` and ``attention_bound`` are the repository's chip_smoke.py
arithmetic, copied: the larger of the bytes over the memory rate and the
operations over the peak rate for their type.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def bound(bytes_moved: float, operations: float, peak_ops: float) -> dict:
    memory_s = bytes_moved / PEAK_BYTES_PER_S
    compute_s = operations / peak_ops
    return {"bound_s": max(memory_s, compute_s),
            "bound_by": "bytes" if memory_s >= compute_s else "operations"}


def attention_bound(B: int, N: int, S: int, D: int) -> dict:
    """Unmasked attention of B rows of S tokens, N heads of width D, in
    bf16: q, k and v read and the output written once, Q.K^T and P.V at 2
    operations a multiply-add, on the bf16 tensor-core peak."""
    bytes_moved = 4 * B * S * N * D * 2
    operations = 2 * N * D * (2 * B * S * S)
    return bound(bytes_moved, operations, PEAK_BF16_FLOPS)
