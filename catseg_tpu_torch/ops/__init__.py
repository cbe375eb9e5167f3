"""Torch-native primitives in catseg_tpu's NHWC layouts."""
from .attention import plain_attention
from .conv import avg_pool2d, conv2d, conv_transpose2d_nonoverlap, patchify
from .norm import group_norm, layer_norm
from .resize import cubic_weights, linear_weights, resize_bicubic, resize_bilinear
from .unfold import fold_divisor, fold_tiles, unfold_tiles
from .window import window_partition, window_reverse

__all__ = [
    "plain_attention", "avg_pool2d", "conv2d", "conv_transpose2d_nonoverlap", "patchify",
    "group_norm", "layer_norm", "cubic_weights", "linear_weights", "resize_bicubic", "resize_bilinear",
    "fold_divisor", "fold_tiles", "unfold_tiles", "window_partition", "window_reverse",
]
