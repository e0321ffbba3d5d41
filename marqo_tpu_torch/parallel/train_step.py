"""Contrastive fine-tuning step for the BERT encoder over a mesh (port of
marqo_tpu/parallel/train_step.py).

In-batch InfoNCE (the e5/CLIP training objective) over a (dp, tp) mesh:

  - fp32 master parameters on the mesh's lead device, updated by
    ``torch.optim.AdamW`` with optax.adamw's defaults;
  - every step builds each data-parallel group's tp shards from the master
    (parallel/encode.py ``ShardedTextEncoder`` through
    ``torch.func.functional_call``) by slicing, casting and copying, all
    differentiable, so autograd sums each parameter's gradient over the
    groups and shards: the psum XLA inserts;
  - the batch splits over dp; the pooled (B, H) embeddings are gathered on
    the lead device for the loss, which needs the whole gallery (the JAX
    package's all-gather of the pooled embeddings).

Training runs the plain twins (``attention_impl`` and ``linear_impl``
"plain"), the counterpart of the JAX step's einsum attention: kernels B1
and B3 have no autograd formula, so the int8 encoder does not train.
"""

import copy
from dataclasses import replace

import torch
import torch.nn.functional as F
from torch.func import functional_call

from marqo_tpu_torch.models.bert import TextEncoder, TextEncoderConfig
from marqo_tpu_torch.parallel.encode import ShardedTextEncoder
from marqo_tpu_torch.parallel.mesh import (Mesh, encoder_param_specs,
                                           shard_tensors, split_batch)

# optax.adamw's defaults (b1, b2, eps, weight_decay); torch's AdamW
# defaults to weight_decay 1e-2, which would train another model
ADAMW_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def info_nce_loss(query_emb: torch.Tensor, passage_emb: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch InfoNCE. Inputs are L2-normalized (B, H) fp32."""
    logits = (query_emb @ passage_emb.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) +
            F.cross_entropy(logits.T, labels)) * 0.5


def make_train_state(encoder: TextEncoder, mesh: Mesh,
                     learning_rate: float = 1e-5):
    """fp32 master parameters on the mesh's lead device (a copy of
    ``encoder``) and the AdamW optimizer over them: (master, optimizer)."""
    if encoder.config.quantize:
        raise ValueError("the int8 encoder does not train: kernels B1 and "
                         "B3 have no autograd formula")
    master = copy.deepcopy(encoder).to(device=mesh.lead,
                                       dtype=torch.float32)
    master.requires_grad_(True)
    optimizer = torch.optim.AdamW(master.parameters(), lr=learning_rate,
                                  **ADAMW_DEFAULTS)
    return master, optimizer


def make_train_step(config: TextEncoderConfig, mesh: Mesh,
                    optimizer: torch.optim.Optimizer,
                    compute_dtype=torch.bfloat16,
                    temperature: float = 0.05):
    """Returns step(master, batch) -> loss, which updates ``master`` (from
    ``make_train_state``) in place.

    ``batch`` = dict(query_ids, query_mask, passage_ids, passage_mask),
    each (B, S) with B divisible by the dp axis size. Raises ValueError
    for a quantized config, or one whose heads or FFN tp does not divide.
    """
    if config.quantize:
        raise ValueError("the int8 encoder does not train: kernels B1 and "
                         "B3 have no autograd formula")
    config = replace(config, attention_impl="plain", linear_impl="plain")
    groups = mesh.groups()
    with torch.device("meta"):
        templates = {group: ShardedTextEncoder(config, group)
                     for group in set(groups)}

    def encode(shards: dict, ids, mask) -> torch.Tensor:
        """The batch over dp, each group through its shards; the pooled
        embeddings gathered on the lead device."""
        return torch.cat([
            functional_call(templates[group], shards[group], parts)
            .to(mesh.lead)
            for group, parts in zip(groups, split_batch(mesh, ids, mask))])

    def step(master: TextEncoder, batch: dict) -> torch.Tensor:
        params = dict(master.named_parameters())
        specs = encoder_param_specs(master)
        shards = {group: shard_tensors(params, specs, group, compute_dtype)
                  for group in set(groups)}
        q = encode(shards, batch["query_ids"], batch["query_mask"])
        p = encode(shards, batch["passage_ids"], batch["passage_mask"])
        loss = info_nce_loss(q, p, temperature)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
