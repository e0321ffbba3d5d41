"""chip_smoke.py's checks and bounds, on the CPU: the attention bound
counts only the keys the mask needs, and the bf16 tolerance passes the twin
against itself but refuses the twin with a wrong softmax scale; B3's bounds
count each byte once; B3's ragged cases reach its element-wise store
path; each phase line carries its launches per tile loop, a phase's check
of its loop, the timing rows' loop fields and SDPA ratio, and the checks'
hold on both bf16 loops."""

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


def _phase_loops(monkeypatch, **counts):
    loops = {f"{kernel}_{loop}": 0 for kernel in chip_smoke.ATTENTION_COUNTERS
             for loop in ("wgmma", "mma_sync", "fma")}
    loops.update(counts)
    monkeypatch.setitem(chip_smoke.PHASE_LOOPS, "p", loops)


def test_check_loop_needs_every_launch_on_the_loop(monkeypatch):
    """A phase passes only if its launches of the kernel all ran on the
    named loop, and at least one did; the other kernel does not count."""
    _phase_loops(monkeypatch, fused_attention_wgmma=24,
                 masked_attention_mma_sync=3)
    assert chip_smoke.check_loop("p", "fused_attention", "wgmma") == {
        "wgmma": 24, "mma_sync": 0, "fma": 0}
    _phase_loops(monkeypatch, fused_attention_wgmma=24,
                 fused_attention_mma_sync=1)
    with pytest.raises(chip_smoke.SmokeFailure, match="not only on wgmma"):
        chip_smoke.check_loop("p", "fused_attention", "wgmma")
    _phase_loops(monkeypatch)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_loop("p", "fused_attention", "wgmma")


def test_emit_carries_each_phase_loop_delta(monkeypatch, capsys):
    """Each phase line carries the loop launches since the line before,
    and PHASE_LOOPS keeps them by phase."""
    import json
    monkeypatch.setattr(chip_smoke, "_loop_mark", {})
    monkeypatch.setattr(chip_smoke, "PHASE_LOOPS", {})
    monkeypatch.setitem(fa.LOOP_LAUNCHES, "wgmma", 5)
    chip_smoke.emit("first")
    monkeypatch.setitem(fa.LOOP_LAUNCHES, "wgmma", 8)
    monkeypatch.setitem(fused.LOOP_LAUNCHES, "mma_sync",
                        fused.LOOP_LAUNCHES["mma_sync"] + 2)
    chip_smoke.emit("second", ok=True)
    first, second = (json.loads(line) for line in
                     capsys.readouterr().out.splitlines())
    assert "loop_launches" not in first
    delta = second["loop_launches"]
    assert delta["masked_attention_wgmma"] == 3
    assert delta["fused_attention_mma_sync"] == 2
    assert sum(delta.values()) == 5
    assert chip_smoke.PHASE_LOOPS == {"second": delta}


def test_loop_times_times_the_other_loop_twice():
    runs = []

    def timer(fn, iters):
        fn()
        return 0.5 + len(runs)

    out = chip_smoke.loop_times(lambda loop: runs.append(loop), 577, 64,
                                timer, 20)
    assert runs == ["mma_sync", "mma_sync"]
    assert out == {"loop": "wgmma", "other_loop": "mma_sync",
                   "other_loop_ms": 2.0, "other_loop_ms_runs": [1.5, 2.5]}
    runs.clear()
    assert chip_smoke.loop_times(lambda loop: runs.append(loop), 8, 64,
                                 timer, 20)["other_loop"] == "wgmma"


def test_sdpa_ratio_is_the_kernel_over_the_library_call():
    rows = chip_smoke.with_sdpa_ratio([
        {"kernel": "fused_attention", "ms": 0.03, "library_ms": 0.04},
        {"kernel": "masked_attention", "ms": 0.1, "library_ms": 0.08},
        {"kernel": "w8a8_matmul", "ms": 0.2, "library_ms": 2.3}])
    assert rows[0]["sdpa_ratio"] == pytest.approx(0.75)
    assert rows[1]["sdpa_ratio"] == pytest.approx(1.25)
    assert "sdpa_ratio" not in rows[2]


@pytest.mark.parametrize("dtype,S,loops", [
    (torch.float32, 257, ["fma"]),
    (torch.bfloat16, 257, ["wgmma", "mma_sync"]),
    (torch.bfloat16, 8, ["mma_sync", "wgmma"])])
def test_kernel_outputs_hold_both_bf16_loops(monkeypatch, dtype, S, loops):
    """The checks hold the rule's loop first, then in bf16 the other loop
    forced on the same inputs; fp32 has only its loop."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    forced = []
    out = chip_smoke.kernel_outputs("rule", lambda loop: forced.append(loop)
                                    or loop, S, 64, dtype)
    assert [loop for loop, _ in out] == loops
    assert out[0][1] == "rule" and forced == loops[1:]
