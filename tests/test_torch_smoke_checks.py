"""chip_smoke.py's checks and bounds, on the CPU: the attention bound
counts only the keys the mask needs, and the bf16 tolerance passes the twin
against itself but refuses the twin with a wrong softmax scale; B3's bounds
count each byte once; B3's ragged cases reach its element-wise store
path."""

import pytest
import torch

import chip_smoke
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused

# (mode, ids of two batch rows of S = 4, K keys read, V keys read, allowed
# (query, key) pairs, queries that see no key), counted by hand
BOUND_CASES = [
    # row 0 has two real keys; row 1 is all pad: no K, V of all four keys
    ("padding", [[1, 1, 0, 0], [0, 0, 0, 0]], 2, 2 + 4, 4 * 2, 4),
    # query 2 of row 0 is a pad query: V of every key of that row, no K of
    # key 2; row 1 is one segment
    ("segment", [[1, 1, 0, 2], [3, 3, 3, 3]], 3 + 4, 4 + 4, 5 + 16, 1),
    # B2: id 0 is a segment, every key is read
    ("fused_segment", [[1, 1, 0, 2], [3, 3, 3, 3]], 8, 8, 6 + 16, 0),
    ("nomask", None, 8, 8, 2 * 16, 0),
]


@pytest.mark.parametrize("mode,ids,k_keys,v_keys,pairs,blind", BOUND_CASES)
def test_attention_bound_counts_what_the_mask_needs(monkeypatch, mode, ids,
                                                    k_keys, v_keys, pairs,
                                                    blind):
    B, N, S, D = 2, 3, 4, 8
    monkeypatch.setattr(chip_smoke, "bound", lambda b, o, peak: (b, o))
    ids = None if ids is None else torch.tensor(ids, dtype=torch.int32)
    bytes_moved, operations = chip_smoke.attention_bound(B, N, S, D, mode,
                                                         ids)
    mask_bytes = 0 if ids is None else 4 * B * S
    assert bytes_moved == (2 * B * S + k_keys + v_keys) * N * D * 2 + \
        mask_bytes
    assert operations == 2 * N * D * (2 * pairs + blind * S)


TWINS = [
    ("padding", lambda q, k, v, pad, seg: fa.attention_padding_reference(
        q, k, v, pad)),
    ("segment", lambda q, k, v, pad, seg: fa.attention_segment_reference(
        q, k, v, seg)),
    ("fused_nomask", lambda q, k, v, pad, seg:
     fused.fused_attention_reference(q, k, v)),
    ("fused_segment", lambda q, k, v, pad, seg:
     fused.fused_attention_reference(q, k, v, segment_ids=seg)),
]


@pytest.mark.parametrize("name,twin", TWINS)
def test_bf16_tolerance_refuses_a_wrong_softmax_scale(monkeypatch, name,
                                                      twin):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    q, k, v, pad, seg = chip_smoke.attention_inputs(4, 3, 64, 32,
                                                    torch.bfloat16, seed=5)
    ref = twin(q, k, v, pad, seg)
    control = twin(q * chip_smoke.SCALE_CONTROL, k, v, pad, seg)
    result = chip_smoke.check_attention(ref, ref, control, name)
    assert result["max_abs_err"] == 0 and result["excess"] <= 0
    assert result["control_excess"] > chip_smoke.ATOL["bfloat16"]
    # the wrong scale as the kernel's output fails the check
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds"):
        chip_smoke.check_attention(control, ref, None, name)
    # a control the tolerance cannot tell from the twin fails it too
    with pytest.raises(chip_smoke.SmokeFailure, match="passes a softmax"):
        chip_smoke.check_attention(ref, ref, ref, name)


@pytest.mark.parametrize("M,K,N,bytes_moved,operations", [
    # bf16 x, int8 w_q, fp32 w_scale and bias, bf16 out; 2 M K N int8 ops
    (32768, 768, 3072, 32768 * 768 * 2 + 3072 * 768 + 3072 * 8 +
     32768 * 3072 * 2, 2 * 32768 * 768 * 3072),
    (32, 768, 2304, 32 * 768 * 2 + 2304 * 768 + 2304 * 8 + 32 * 2304 * 2,
     2 * 32 * 768 * 2304),
])
def test_w8a8_bound_counts_each_byte_once(monkeypatch, M, K, N, bytes_moved,
                                          operations):
    monkeypatch.setattr(chip_smoke, "bound", lambda b, o, peak: (b, o, peak))
    assert chip_smoke.w8a8_bound(M, K, N) == (bytes_moved, operations,
                                              chip_smoke.PEAK_INT8_OPS)


@pytest.mark.parametrize("K,bound_ms", [(768, 0.0225), (3072, 0.0901)])
def test_quantize_bound_is_the_bytes_of_one_read_and_one_write(K, bound_ms):
    """bf16 x read once, int8 x_q and the fp32 scales written once: 75 MB
    at K = 768 and 300 MB at K = 3072 for the padded ingest batch."""
    bound = chip_smoke.quantize_bound(32768, K)
    assert bound["bound_by"] == "bytes"
    assert abs(bound["bound_ms"] - bound_ms) < 1e-4


def test_w8a8_ragged_cases_reach_the_element_wise_store_path():
    """Some ragged N give bf16 output rows whose stride is not a multiple
    of 16 bytes, and the cases span the 64- and 128-wide GEMM tiles."""
    ns = [N for _, _, N in chip_smoke.W8A8_RAGGED]
    assert any(N * 2 % 16 for N in ns) and any(N * 4 % 16 for N in ns)
    assert min(M for M, _, _ in chip_smoke.W8A8_RAGGED) == 1
    assert max(M for M, _, _ in chip_smoke.W8A8_RAGGED) > 4096
    assert all(K % 16 == 0 for _, K, _ in chip_smoke.W8A8_RAGGED)
    assert (768, 2304) in chip_smoke.W8A8_WIDTHS
    assert (768, 2304) in chip_smoke.W8A8_PATH_WIDTHS
