"""Class names -> normalized text features (catseg_tpu/text/embed.py,
forward path: first synonym only, one embedding per template)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import CLIP, encode_text, truncate_context
from . import templates as _templates
from .tokenizer import ClipBPE, tokenize


@torch.no_grad()
def encode_texts_batched(clip: CLIP, token_ids: np.ndarray, batch: int = 256,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """Encode (N, 77) token rows in batches -> (N, E) fp32 on the model's device."""
    token_ids = truncate_context(token_ids)
    device = clip.positional_embedding.device
    outs = [encode_text(clip, torch.as_tensor(token_ids[i:i + batch], device=device), compute_dtype).float()
            for i in range(0, token_ids.shape[0], batch)]
    return torch.cat(outs, dim=0)


def forward_text_embeds(clip: CLIP, class_names: list[str], template_set: str | tuple[str, ...],
                        tokenizer: ClipBPE | None = None, compute_dtype=torch.float32) -> torch.Tensor:
    """(T, P, E) L2-normalized fp32 text features on the model's device."""
    temps = _templates.get(template_set) if isinstance(template_set, str) else template_set
    texts = []
    for name in class_names:
        first = name.split(", ")[0] if ", " in name else name
        texts.extend(_templates.format_template(t, first) for t in temps)
    emb = encode_texts_batched(clip, tokenize(texts, tokenizer=tokenizer), compute_dtype=compute_dtype)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    return emb.reshape(len(class_names), len(temps), -1)
