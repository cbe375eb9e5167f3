"""Sliding-window tile unfold / fold and the overlap divisor
(catseg_tpu/ops/unfold.py; nn.Unfold / nn.Fold semantics on NHWC)."""

from __future__ import annotations

import torch


def _tile_origins(size: int, kernel: int, stride: int) -> list[int]:
    return [i * stride for i in range((size - kernel) // stride + 1)]


def unfold_tiles(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (nTiles * B, kernel, kernel, C), tile-major row-major order."""
    ys = _tile_origins(x.shape[1], kernel, stride)
    xs = _tile_origins(x.shape[2], kernel, stride)
    return torch.cat([x[:, y:y + kernel, xo:xo + kernel] for y in ys for xo in xs], dim=0)


def fold_tiles(tiles: torch.Tensor, out_hw: tuple[int, int], kernel: int, stride: int) -> torch.Tensor:
    """Inverse of unfold_tiles with overlaps summed (no normalization), in fp32
    and in tile order, result in the tiles' dtype."""
    H, W = out_hw
    origins = [(y, xo) for y in _tile_origins(H, kernel, stride) for xo in _tile_origins(W, kernel, stride)]
    B = tiles.shape[0] // len(origins)
    out = torch.zeros((B, H, W, tiles.shape[-1]), dtype=torch.float32, device=tiles.device)
    for i, (y, xo) in enumerate(origins):
        out[:, y:y + kernel, xo:xo + kernel] += tiles[i * B:(i + 1) * B].float()
    return out.to(tiles.dtype)


def fold_divisor(out_hw: tuple[int, int], kernel: int, stride: int, device=None) -> torch.Tensor:
    """Overlap count fold(unfold(ones)), shape (H, W, 1) fp32."""
    def count(n):
        i = torch.arange(n, device=device)
        o = torch.tensor(_tile_origins(n, kernel, stride), device=device)
        return ((i[None] >= o[:, None]) & (i[None] < o[:, None] + kernel)).sum(0).float()

    H, W = out_hw
    return (count(H)[:, None] * count(W)[None, :])[:, :, None]
