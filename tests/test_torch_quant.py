"""marqo_tpu_torch's W8A8 ops (ops/quant.py, ops/quant_matmul.py) against
marqo_tpu's (ops/quant.py and the Pallas kernel in ops/quant_matmul.py).

The same numpy inputs go to both. The port keeps weights in nn.Linear's
(out, in) layout, so JAX's (in, out) arrays are compared transposed. On the
CPU the port runs B3's plain twin, which must equal JAX's ``int8_linear``
bit for bit in fp32 (float64 holds the int8 sums exactly, and the epilogue
runs in fp32 in the same order), and come within atol 1e-4, rtol 1e-6 of
the Pallas kernel in interpret mode (its int32 dot and XLA's round alike;
outputs reach ~150).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp
from marqo_tpu.ops import quant as jquant
from marqo_tpu.ops import quant_matmul as jqm
from marqo_tpu_torch.ops import quant as tquant
from marqo_tpu_torch.ops import quant_matmul as tqm


def _inputs(shape, K, N, seed):
    """x (*shape, K) with rows over four decades, w (K, N), bias (N,).
    JAX's int8_linear takes 3-D x (B, S, K)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, K)).astype(np.float32)
    x *= (10.0 ** rng.uniform(-2, 2, (*shape, 1))).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return x, w, bias


def _both_weights(w):
    """JAX's quantize_weight of (in, out) w, and the port's of w.T."""
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(
        w.T)))
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("K,N", [(64, 32), (768, 512), (96, 200)])
def test_quantize_weight_matches_jax(K, N):
    _, w, _ = _inputs((1,), K, N, seed=K)
    (jq, js), (tq, ts) = _both_weights(w)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == (N, K) and tuple(ts.shape) == (N,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])


def test_quantize_stacked_weight_matches_jax():
    rng = np.random.default_rng(3)
    w = (0.02 * rng.standard_normal((3, 48, 80))).astype(np.float32)
    w[1, :, 5] = 0  # an all-zero output channel: the 1e-8 scale floor
    jq, js = jquant.quantize_stacked_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_stacked_weight(
        torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))))
    assert tuple(tq.shape) == (3, 80, 48) and tuple(ts.shape) == (3, 80)
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jq).transpose(0, 2, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:, 0])
    assert float(ts[1, 5]) == np.float32(1e-8)


def test_quantize_activations_matches_jax():
    x, _, _ = _inputs((2, 8), 64, 1, seed=4)
    jq, js = jquant._quantize_activations(jnp.asarray(x))
    tq, ts = tquant._quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape,K,N", [((2, 8), 64, 32), ((1, 256), 768, 512),
                                       ((1, 37), 96, 200), ((3, 5), 16, 1),
                                       ((1, 9), 5120, 48), ((2, 3), 40, 24)])
def test_int8_linear_fp32_equals_jax(shape, K, N):
    """Array-equal in fp32, ragged M and N included, and the K the CUDA
    kernel took only after ROADMAP C1: 5120 (longer than one warp's
    registers) and 40 (not a multiple of 16)."""
    x, w, bias = _inputs(shape, K, N, seed=K + N)
    (jq, js), (tq, ts) = _both_weights(w)
    ref = jquant.int8_linear(jnp.asarray(x), jq, js[0], jnp.asarray(bias),
                             out_dtype=jnp.float32)
    out = tquant.int8_linear(torch.from_numpy(x), tq, ts,
                             torch.from_numpy(bias))
    assert out.dtype == torch.float32 and tuple(out.shape) == (*shape, N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,K,N", [((2, 8), 64, 32), ((1, 256), 768, 512)])
def test_int8_linear_bf16_within_one_ulp_of_jax(shape, K, N):
    """bf16 x and bias, bf16 out (the JAX encoder passes out_dtype=x.dtype
    and its bias in the compute dtype)."""
    x, w, bias = _inputs(shape, K, N, seed=K * N)
    (jq, js), (tq, ts) = _both_weights(w)
    ref = jquant.int8_linear(
        jnp.asarray(x).astype(jnp.bfloat16), jq, js[0],
        jnp.asarray(bias).astype(jnp.bfloat16), out_dtype=jnp.bfloat16)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    out = tquant.int8_linear(torch.from_numpy(x).bfloat16(), tq, ts,
                             torch.from_numpy(bias).bfloat16())
    assert out.dtype == torch.bfloat16
    assert ((out.float() - ref).abs() <= bf16_ulp(ref)).all()


def test_ties_round_half_to_even():
    """absmax 127 makes x_scale exactly 1: 2.5 and 3.5 land on ties and
    round to 2 and 4 (jnp.round and torch.round), never 3 and 4."""
    x = np.zeros((1, 1, 16), np.float32)
    x[0, 0, :4] = [127.0, 2.5, 3.5, -2.5]
    # w_scale 1 and w_q 127 on the diagonal: out = 127 * x_q
    w = np.eye(16, 4, dtype=np.float32) * 127.0
    (jq, js), (tq, ts) = _both_weights(w)
    zeros = np.zeros(4, np.float32)
    ref = np.asarray(jquant.int8_linear(jnp.asarray(x), jq, js[0],
                                        jnp.asarray(zeros),
                                        out_dtype=jnp.float32))
    out = tquant.int8_linear(torch.from_numpy(x), tq, ts,
                             torch.from_numpy(zeros)).numpy()
    np.testing.assert_array_equal(out, 127.0 * np.array(
        [[[127.0, 2.0, 4.0, -2.0]]], np.float32))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("M,K,N", [(256, 128, 512), (512, 64, 1024)])
def test_twin_matches_pallas_kernel(M, K, N):
    """tests/test_quantization.py:85-110 runs the Pallas kernel the same
    way: interpret mode on the CPU; (512, 64, 1024) is its 2 x 2 grid."""
    x, w, bias = _inputs((M,), K, N, seed=M + K)
    (jq, js), (tq, ts) = _both_weights(w)
    ref = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), jq, js[0],
                                     jnp.asarray(bias),
                                     out_dtype=jnp.float32))
    out = tqm.w8a8_matmul(torch.from_numpy(x), tq, ts,
                          torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-6)


def test_cpu_tensor_takes_the_twin_and_counts_no_launch():
    x, w, bias = _inputs((8,), 32, 16, seed=9)
    _, (tq, ts) = _both_weights(w)
    before = tqm.LAUNCHES["w8a8"]
    args = (torch.from_numpy(x), tq, ts, torch.from_numpy(bias))
    assert torch.equal(tqm.w8a8_matmul(*args),
                       tqm.w8a8_matmul_reference(*args))
    assert tqm.LAUNCHES["w8a8"] == before


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("x,w_q,w_scale,bias,match", [
    (_meta((4, 40)), _meta((8, 40), torch.int8), _meta(8), _meta(8),
     "multiple of 16"),
    (_meta((4, 131088)), _meta((8, 131088), torch.int8), _meta(8), _meta(8),
     "up to 131072"),
    (_meta((4, 64), torch.float16), _meta((8, 64), torch.int8), _meta(8),
     _meta(8), "fp32 or bf16"),
    (_meta((4, 64)), _meta((8, 64)), _meta(8), _meta(8), "int8"),
    (_meta((4, 64)), _meta((8, 32), torch.int8), _meta(8), _meta(8),
     "int8"),
    (_meta((2, 4, 64)), _meta((8, 64), torch.int8), _meta(8), _meta(8),
     "2-D"),
    (_meta((4, 64)), _meta((8, 64), torch.int8), _meta(7), _meta(8),
     "w_scale"),
    (_meta((4, 64)), _meta((8, 64), torch.int8), _meta(8),
     _meta(8, torch.bfloat16), "bias"),
    (_meta((0, 64)), _meta((8, 64), torch.int8), _meta(8), _meta(8),
     "M=0"),
])
def test_check_kernel_inputs_refuses(x, w_q, w_scale, bias, match):
    with pytest.raises(ValueError, match=match):
        tqm.check_kernel_inputs(x, w_q, w_scale, bias)


def test_check_kernel_inputs_accepts_the_encoder_shapes():
    for K, N in ((768, 768), (768, 3072), (3072, 768), (384, 1536),
                 (1024, 4096), (5120, 1280), (1280, 5120)):
        tqm.check_kernel_inputs(_meta((37, K), torch.bfloat16),
                                _meta((N, K), torch.int8), _meta(N),
                                _meta(N))
