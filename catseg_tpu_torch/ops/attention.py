"""The reference's plain attention composition (catseg_tpu/core/dino.py,
sam.py, sam_decoder.py): the second encoders and the mask decoder run it,
as the reference runs no kernel there."""

from __future__ import annotations

import torch


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None) -> torch.Tensor:
    """softmax(q k^T [+ bias]) v over (..., N, D) heads, as the reference's
    einsums compute it: fp32 logits, fp32 softmax, the probabilities rounded
    to q's dtype, an fp32 value product rounded to q's dtype.  q comes
    scaled; ``bias`` maps the fp32 logits to biased ones."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = bias(logits)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    return torch.matmul(attn.float(), v.float()).to(q.dtype)
