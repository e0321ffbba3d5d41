"""DeepSeek-V2's elementwise passes around its attention and MLP blocks:
the residual add folded into the RMSNorm that follows it, and RoPE folded
into the assembly of latent attention's q and k (models/deepseek_v2.py).

It replaces no TPU kernel: the JAX package has no decoder LLM. It was
added because these chains ran as PyTorch's generic elementwise kernels,
each a pass over device memory in fp32, and took as long on the card as
any kernel but the expert layer's grouped GEMM.

- ``add_rms_norm``: s = x + delta in the input dtype (x itself without
  delta), then RMSNorm of s with its statistics in fp32, normalised in
  fp32, rounded, then scaled in the input dtype: the rounding points of
  ``x + delta`` followed by transformers' DeepSeek-V2 RMSNorm. Returns
  (s, normed); s is None where the caller keeps no sum (the final norm).
  x's rows may lie a stride apart (the latent's ``kv[..., :512]`` is read in
  place).
- ``mla_rope``: q's RoPE part rotated in place on interleaved pairs, and k
  assembled whole: each head's no-RoPE key from ``kv_b`` and the one RoPE
  key a token shares, rotated once and written to every head. The rotation
  in fp32 from the (cos, sin) tables of ``rope_tables``, rounded once.

On a CUDA device each is one hand-written pass of ``csrc/decoder_glue.cu``
(bf16 alone, the model's compute dtype; bytes-bound: each bf16 input read
once, fp32 only in registers, each output written once); on the CPU its
twin (``add_rms_norm_reference``, ``mla_rope_reference``), the plain
PyTorch composition the passes replace. ``LAUNCHES`` counts each kernel's
launches, replays of a CUDA graph included (ops/launches.py); a norm launch
reaches ops/launches.py under the name of its case (``_norm_case``) with
its shape (rows, W, row stride), so a reader tells the cases apart.
"""

import torch

from marqo_tpu_torch.ops import _build, launches

LAUNCHES = {"add_rms_norm": 0, "mla_rope": 0}
# what the passes take: bf16 in 16-byte vectors of 8; a row of the norm in
# one warp's registers, 8 vectors a lane; the shared RoPE key of a token in
# 16 vectors of shared memory (csrc/decoder_glue.cu)
VALUES_A_VECTOR = 8
MAX_WIDTH = 32 * 8 * VALUES_A_VECTOR
MAX_ROPE = 16 * VALUES_A_VECTOR


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, scaled in x's dtype (the twin's
    arithmetic)."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return scale * normed.to(x.dtype)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x (..., d) rotated on interleaved pairs in fp32, in x's dtype (the
    twin's arithmetic)."""
    x32 = x.float()
    even, odd = x32[..., 0::2], x32[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).flatten(-2).to(x.dtype)


def _row_stride(t: torch.Tensor):
    """The distance in values between consecutive rows of t (..., W) when
    its last axis is contiguous and its rows lie evenly apart; else None."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    if t.dim() == 1:
        return t.shape[-1]
    stride = t.stride(-2)
    for i in range(t.dim() - 2):
        if t.shape[i] > 1 and t.stride(i) != t.stride(i + 1) * t.shape[i + 1]:
            return None
    return stride


def _norm_case(with_delta: bool, keeps_sum: bool, strided: bool) -> str:
    """A norm launch's counter name: the residual add with its sum written;
    the add whose sum nothing reads; a plain norm of contiguous rows; a
    plain norm of rows read in place from wider ones."""
    if with_delta:
        return "add_rms_norm_residual" if keeps_sum else "add_rms_norm_nosum"
    return "add_rms_norm_strided" if strided else "add_rms_norm_plain"


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def check_add_rms_norm_inputs(x: torch.Tensor, delta, scale: torch.Tensor
                              ) -> None:
    """Raise ValueError unless the norm kernel takes these tensors (device
    aside): x bf16 (..., W) with at least one row, its last axis contiguous,
    its rows evenly strided (a multiple of 8 values apart), W a multiple of 8
    up to MAX_WIDTH; delta None or bf16 of x's shape, contiguous; scale bf16
    (W,), contiguous; all 16-byte aligned and on one device."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"add_rms_norm: x must be bf16, got {x.dtype}")
    W = x.shape[-1] if x.dim() else 0
    if x.numel() == 0 or W % VALUES_A_VECTOR or W > MAX_WIDTH:
        raise ValueError(f"add_rms_norm: x must be (..., W) with rows and W a "
                         f"multiple of {VALUES_A_VECTOR} up to {MAX_WIDTH}, "
                         f"got {tuple(x.shape)}")
    stride = _row_stride(x)
    if stride is None or stride % VALUES_A_VECTOR or not _aligned(x):
        raise ValueError("add_rms_norm: x must have a contiguous last axis, "
                         "evenly strided rows a multiple of 8 values apart, "
                         "and be 16-byte aligned")
    for name, t, shape in (("delta", delta, tuple(x.shape)),
                           ("scale", scale, (W,))):
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"add_rms_norm: {name} must be bf16 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or not _aligned(t):
            raise ValueError(f"add_rms_norm: {name} must be contiguous and "
                             f"16-byte aligned")
        if t.device != x.device:
            raise ValueError("add_rms_norm: x, delta and scale must share a "
                             "device")


def add_rms_norm(x: torch.Tensor, delta, scale: torch.Tensor, eps: float,
                 keep_sum: bool = True):
    """(s, normed): s = x + delta (x where delta is None), normed =
    RMSNorm(s) * scale, both (..., W) in x's dtype (bf16 on the card);
    s None where ``keep_sum`` is False. The kernel on a CUDA device, the
    twin on the CPU."""
    if x.device.type == "cpu":
        return add_rms_norm_reference(x, delta, scale, eps, keep_sum)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: unsupported device {x.device}")
    check_add_rms_norm_inputs(x, delta, scale)
    W = x.shape[-1]
    rows = x.numel() // W
    stride = _row_stride(x)
    normed = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    total = None
    if delta is not None and keep_sum:
        total = torch.empty_like(normed)
    with torch.cuda.device(x.device):
        err = _build.load_library().marqo_add_rms_norm(
            x.data_ptr(), stride,
            None if delta is None else delta.data_ptr(), scale.data_ptr(),
            None if total is None else total.data_ptr(), normed.data_ptr(),
            rows, W, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    case = _norm_case(delta is not None, total is not None, stride != W)
    launches.count(launches.Launch(LAUNCHES, "add_rms_norm", None, None,
                                   case, (rows, W, stride)))
    if delta is None:
        total = x if keep_sum else None
    return total, normed


def add_rms_norm_reference(x: torch.Tensor, delta, scale: torch.Tensor,
                           eps: float, keep_sum: bool = True):
    """The plain twin of ``add_rms_norm``: ``x + delta``, then ``rms_norm``."""
    s = x if delta is None else x + delta
    return (s if keep_sum else None), rms_norm(s, scale, eps)


def check_mla_rope_inputs(q: torch.Tensor, kv_b: torch.Tensor,
                          key: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> None:
    """Raise ValueError unless the RoPE kernel takes these tensors (device
    aside): q bf16 (..., N, nope + rope) and kv_b bf16 (..., N, width >=
    nope), both contiguous; key bf16 (..., rope), its last axis contiguous
    and its rows evenly strided; cos and sin fp32 (..., 1, rope / 2),
    contiguous; nope, rope, width and key's row stride multiples of 8, rope
    from 8 to MAX_ROPE; the leading axes alike, with at least one token;
    all 16-byte aligned and on one device."""
    tensors = (("q", q, torch.bfloat16), ("kv_b", kv_b, torch.bfloat16),
               ("key", key, torch.bfloat16), ("cos", cos, torch.float32),
               ("sin", sin, torch.float32))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise ValueError(f"mla_rope: {name} must be {dtype}, got "
                             f"{t.dtype}")
    if q.dim() < 3 or q.numel() == 0:
        raise ValueError(f"mla_rope: q must be (..., N, D) with tokens, got "
                         f"{tuple(q.shape)}")
    lead, N = tuple(q.shape[:-2]), q.shape[-2]
    rope = key.shape[-1] if key.dim() else 0
    nope = q.shape[-1] - rope
    shapes = {"kv_b": (lead + (N,), tuple(kv_b.shape[:-1])),
              "key": (lead, tuple(key.shape[:-1])),
              "cos": (lead + (1, rope // 2), tuple(cos.shape)),
              "sin": (lead + (1, rope // 2), tuple(sin.shape))}
    for name, (expected, got) in shapes.items():
        if expected != got:
            raise ValueError(f"mla_rope: {name}'s shape {got} does not fit q "
                             f"{tuple(q.shape)} (expected {expected})")
    widths = (nope, rope, kv_b.shape[-1])
    if not VALUES_A_VECTOR <= rope <= MAX_ROPE or nope < 0 or \
            kv_b.shape[-1] < nope or any(w % VALUES_A_VECTOR for w in widths):
        raise ValueError(f"mla_rope: nope {nope}, rope {rope} and kv_b's "
                         f"width {kv_b.shape[-1]} must be multiples of "
                         f"{VALUES_A_VECTOR}, rope >= {VALUES_A_VECTOR} and "
                         f"<= {MAX_ROPE}, width >= nope")
    stride = _row_stride(key)
    if stride is None or stride % VALUES_A_VECTOR:
        raise ValueError("mla_rope: key must have a contiguous last axis and "
                         "evenly strided rows a multiple of 8 values apart")
    if not all(t.is_contiguous() for t in (q, kv_b, cos, sin)) or \
            not all(_aligned(t) for _, t, _ in tensors):
        raise ValueError("mla_rope: q, kv_b, cos and sin must be contiguous, "
                         "all inputs 16-byte aligned")
    if any(t.device != q.device for _, t, _ in tensors):
        raise ValueError("mla_rope: q, kv_b, key, cos and sin must share a "
                         "device")


def mla_rope(q: torch.Tensor, kv_b: torch.Tensor, key: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """q (..., N, nope + rope): its last ``rope`` values rotated in place;
    returns k (..., N, nope + rope): kv_b[..., :nope] beside key (..., rope)
    rotated and shared by the N heads. cos, sin (..., 1, rope / 2) fp32. The
    kernel on a CUDA device, the twin on the CPU."""
    if q.device.type == "cpu":
        return mla_rope_reference(q, kv_b, key, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"mla_rope: unsupported device {q.device}")
    check_mla_rope_inputs(q, kv_b, key, cos, sin)
    N, D = q.shape[-2:]
    rope = key.shape[-1]
    tokens = q.numel() // (N * D)
    k = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.load_library().marqo_mla_rope(
            q.data_ptr(), k.data_ptr(), kv_b.data_ptr(), key.data_ptr(),
            _row_stride(key), cos.data_ptr(), sin.data_ptr(), tokens, N,
            D - rope, rope, kv_b.shape[-1],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_rope kernel launch failed: CUDA error {err}")
    launches.count(launches.Launch(LAUNCHES, "mla_rope", None, None,
                                   "mla_rope", (tokens, N, D)))
    return k


def mla_rope_reference(q: torch.Tensor, kv_b: torch.Tensor, key: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``mla_rope``: k's no-RoPE part copied from kv_b,
    its RoPE part the key rotated and broadcast over the heads, then q's
    RoPE part rotated in place."""
    nope = q.shape[-1] - key.shape[-1]
    k = torch.empty_like(q)
    k[..., :nope] = kv_b[..., :nope]
    k[..., nope:] = rotate(key[..., None, :], cos, sin)
    q[..., nope:] = rotate(q[..., nope:], cos, sin)
    return k
