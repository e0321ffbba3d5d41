"""Tensor-parallel BERT encoding over a mesh (port of
marqo_tpu/parallel/encode.py).

``ShardedTextEncoder`` is models/bert.py's float ``TextEncoder`` split over
one data-parallel group's tp devices. Shard r holds heads
[r·N/tp, (r+1)·N/tp) of q, k and v (their output rows), the matching input
columns of ``attn_out``, and FFN columns [r·I/tp, (r+1)·I/tp) of ``ffn_in``
and ``ffn_out``; embeddings, LayerNorms and the output biases replicate
(parallel/mesh.py ``encoder_param_specs``). Per block each shard runs its
own heads through the config's attention (kernel B1 on a CUDA device, at
(B, N/tp, S, D)) and its partial ``attn_out`` product; the partials are
summed on the group's first device in shard order, in the compute dtype,
where XLA would insert a psum, then come the bias, the residual and the
LayerNorm, once. The FFN works the same way. On a virtual mesh (one device
repeated) every copy is a no-op and the shards are views of the encoder's
weights; over distinct devices each shard owns its part. ``make_sharded_encode`` adds the data-parallel split.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.models.bert import (_ATTENTION, QKV, Embeddings,
                                         TextEncoder, TextEncoderConfig,
                                         encode_tokens)
from marqo_tpu_torch.ops.common import ACTIVATIONS, layer_norm
from marqo_tpu_torch.parallel.mesh import (AXIS_TP, Mesh, check_tp_divides,
                                           encoder_param_specs, shard_tensors,
                                           split_batch)


class _LayerShard(nn.Module):
    """One block's tp shard: ``EncoderLayer``'s names at 1/tp of the heads
    (``width``) and of the FFN (``ffn``)."""

    def __init__(self, hidden: int, width: int, ffn: int):
        super().__init__()
        self.query = nn.Linear(hidden, width)
        self.key = nn.Linear(hidden, width)
        self.value = nn.Linear(hidden, width)
        self.attn_out = nn.Linear(width, hidden)
        self.attn_ln = nn.LayerNorm(hidden)
        self.ffn_in = nn.Linear(hidden, ffn)
        self.ffn_out = nn.Linear(ffn, hidden)
        self.ffn_ln = nn.LayerNorm(hidden)


class _EncoderShard(nn.Module):
    """A tp shard of ``TextEncoder``, under its parameter names."""

    def __init__(self, config: TextEncoderConfig, tp: int):
        super().__init__()
        H = config.hidden_size
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(
            _LayerShard(H, H // tp, config.intermediate_size // tp)
            for _ in range(config.num_layers))


class ShardedTextEncoder(nn.Module):
    """The float BERT encoder over one tp group (``devices``, the first
    leading). It stands in for ``TextEncoder`` in models/bert.py's
    ``encode_tokens`` and ``packed_segment_sums``: ``config``,
    ``embeddings`` and ``run_layers`` take and give tensors on the lead
    device. ``forward`` is ``encode_tokens``, for
    ``torch.func.functional_call`` (parallel/train_step.py)."""

    def __init__(self, config: TextEncoderConfig,
                 devices: Sequence[torch.device]):
        super().__init__()
        if config.quantize:
            raise ValueError("tensor parallelism splits the float encoder; "
                             "the int8 encoder replicates")
        check_tp_divides(config, len(devices))
        self.config = config
        self.devices = [torch.device(d) for d in devices]
        self.shards = nn.ModuleList(
            _EncoderShard(config, len(devices)) for _ in self.devices)

    @classmethod
    def from_encoder(cls, encoder: TextEncoder,
                     devices: Sequence[torch.device]
                     ) -> "ShardedTextEncoder":
        """``encoder``'s weights split over ``devices``: views where every
        device is the encoder's own (a virtual mesh). Over distinct
        devices a split part left on the encoder's device is copied, so
        that it does not keep the whole unsharded weight alive."""
        with torch.device("meta"):
            sharded = cls(encoder.config, devices)
        params = dict(encoder.named_parameters())
        specs = encoder_param_specs(encoder)
        tensors = shard_tensors(params, specs, sharded.devices)
        source = next(encoder.parameters()).device
        if any(d != source for d in sharded.devices):
            tensors = {key: t.clone() if t.device == source and
                       specs[key.split(".", 2)[2]] is not None else t
                       for key, t in tensors.items()}
        sharded.load_state_dict(tensors, assign=True)
        return sharded.eval().requires_grad_(False)

    @property
    def embeddings(self) -> Embeddings:
        return self.shards[0].embeddings

    def forward(self, input_ids, attention_mask):
        return encode_tokens(self, input_ids, attention_mask)

    def run_layers(self, x: torch.Tensor, mode: str,
                   mask_data: torch.Tensor) -> torch.Tensor:
        """``TextEncoder.run_layers`` with each block's heads and FFN split
        over the shards."""
        config = self.config
        attend = _ATTENTION[(config.attention_impl, mode)]
        masks = [mask_data.to(d) for d in self.devices]
        act = ACTIVATIONS[config.hidden_act]
        for i in range(config.num_layers):
            layers = [shard.layers[i] for shard in self.shards]
            x = self._residual(x, layers[0].attn_out, layers[0].attn_ln, [
                self._attention(layer, x.to(d), attend, mask)
                for layer, d, mask in zip(layers, self.devices, masks)])
            x = self._residual(x, layers[0].ffn_out, layers[0].ffn_ln, [
                F.linear(act(layer.ffn_in(x.to(d))), layer.ffn_out.weight)
                for layer, d in zip(layers, self.devices)])
        return x

    def _attention(self, layer: _LayerShard, x: torch.Tensor, attend,
                   mask_data: torch.Tensor) -> torch.Tensor:
        """One shard's heads and its partial ``attn_out`` product (no
        bias)."""
        B, S, _ = x.shape
        D = self.config.head_dim
        # views: the kernels read the projection's layout by strides
        q, k, v = (getattr(layer, name)(x).view(B, S, -1, D).transpose(1, 2)
                   for name in QKV)
        ctx = attend(q, k, v, mask_data).transpose(1, 2).reshape(B, S, -1)
        return F.linear(ctx, layer.attn_out.weight)

    def _residual(self, x: torch.Tensor, out: nn.Linear, ln: nn.LayerNorm,
                  partials: list) -> torch.Tensor:
        """Sum the shards' partial products on the lead device, in shard
        order, then add the bias and the residual and normalize, once."""
        total = partials[0]
        for part in partials[1:]:
            total = total + part.to(self.devices[0])
        return layer_norm(x + (total + out.bias), ln.weight, ln.bias,
                          self.config.layer_norm_eps)


def make_sharded_encode(mesh: Mesh, config: TextEncoderConfig,
                        compute_dtype=torch.bfloat16):
    """Returns encode(sharded, input_ids, attention_mask) over ``mesh``:
    ``sharded`` is parallel/mesh.py ``shard_params(encoder, mesh)`` of an
    encoder held in ``compute_dtype``; the (B, S) inputs split over dp
    (B a multiple of dp) and the pooled fp32 (B, H) embeddings come back
    on the mesh's lead device."""
    check_tp_divides(config, mesh.shape[AXIS_TP])

    def encode(sharded: list, input_ids, attention_mask) -> torch.Tensor:
        dtypes = {p.dtype for replica in sharded
                  for p in replica.parameters()}
        if dtypes != {compute_dtype}:
            held = sorted(map(str, dtypes))
            raise ValueError(f"the shards are held in {held}, not "
                             f"{compute_dtype}")
        outs = [encode_tokens(replica, ids, mask).to(mesh.lead)
                for replica, (ids, mask) in
                zip(sharded, split_batch(mesh, input_ids, attention_mask))]
        return torch.cat(outs)

    return encode
