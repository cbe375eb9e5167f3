"""Interactive SAM predictor: encode an image once, decode many prompts
(catseg_tpu/infer/sam_predictor.py; the vendored SamPredictor,
cat_seg/segment_anything/predictor.py:17-269).

``set_image`` resizes the longest side to the variant's input size
(ResizeLongestSide: ``int(scale * dim + 0.5)``) with the host library's
Pillow-exact BILINEAR (``data.resize.resize_bilinear_u8``; the reference
resizes a PIL image), SAM-normalizes, zero-pads bottom / right to a square
canvas and runs the SAM image encoder in fp32.  ``predict`` embeds point /
box / mask prompts (one not-a-point slot is appended only when no box is
given, prompt_encoder.py:83-87), runs the two-way mask decoder, and
upscales the low-res logits to the input size, crops the pad and upscales
to the original size (modeling/sam.py postprocess_masks).

Takes the port's SAM modules (``core/sam.py``, ``core/sam_decoder.py``):
a Ver14 model's ``sam_encoder`` / ``sam_prompt_encoder`` / ``sam_decoder``,
or the three modules themselves.  Kernels: the encoder's and the mask
decoder's LayerNorms take #1 (``kernels/layer_norm.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import PIXEL_MEAN, PIXEL_STD
from ..core.catseg import resolve_device
from ..core.sam import SAMVariant
from ..core.sam_decoder import dense_pe, no_mask_embed
from ..data.resize import resize_bilinear_u8
from ..ops import resize_bilinear


def resize_longest_side(h: int, w: int, long: int) -> tuple[int, int]:
    """ResizeLongestSide.get_preprocess_shape: int(scale * dim + 0.5)."""
    scale = long / max(h, w)
    return int(scale * h + 0.5), int(scale * w + 0.5)


def sam_modules(model_or_modules, device) -> tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module]:
    """(image encoder, prompt encoder, mask decoder) on ``device`` in eval
    mode, from a Ver14 model (``core.fusion.SAMRefineCATSeg``) or the three
    modules."""
    if isinstance(model_or_modules, (tuple, list)):
        mods = tuple(model_or_modules)
    else:
        m = model_or_modules
        mods = (m.sam_encoder, m.sam_prompt_encoder, m.sam_decoder)
    return tuple(mod.to(device).eval() for mod in mods)


def decode(pe, dec, feat: torch.Tensor, sparse: torch.Tensor, dense: torch.Tensor | None, multimask: bool):
    """One batch of prompt queries against an image embedding ``feat`` (1 or
    B, gh, gw, C): sparse (B, N, C) prompt tokens, dense (B, gh, gw, C) mask
    prompts or None (the no-mask embedding) -> (low-res logits (B, 1 or 3,
    4 gh, 4 gw), IoU predictions)."""
    B = sparse.shape[0]
    gh, gw, C = feat.shape[1:]
    if dense is None:
        dense = no_mask_embed(pe, (gh, gw)).expand(B, gh, gw, C)
    feat = feat.expand(B, gh, gw, C)
    return dec(feat, dense_pe(pe.gauss, (gh, gw)), sparse, dense, multimask_output=multimask)


class SamPredictor:
    """predictor.py's API: ``set_image()`` once, ``predict()`` per prompt."""

    def __init__(self, model_or_modules, variant: SAMVariant | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.encoder, self.pe, self.dec = sam_modules(model_or_modules, self.device)
        self.variant = self.encoder.variant if variant is None else variant
        self.reset_image()

    def reset_image(self) -> None:
        self.features = None
        self.original_size = None
        self.input_size = None

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> (1, S, S, 3) fp32 SAM-normalized canvas on the
        host, the longest side resized to S and zero-padded bottom / right;
        records the original and resized sizes."""
        h, w = image.shape[:2]
        S = self.variant.img_size
        nh, nw = resize_longest_side(h, w, S)
        resized = torch.from_numpy(resize_bilinear_u8(image, (nh, nw)).astype(np.float32))
        canvas = torch.zeros(1, S, S, 3)
        canvas[0, :nh, :nw] = (resized - torch.tensor(PIXEL_MEAN)) / torch.tensor(PIXEL_STD)
        self.original_size = (h, w)
        self.input_size = (nh, nw)
        return canvas

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: (H, W, 3) uint8 RGB."""
        canvas = self.preprocess(image)
        self.features = self.encoder(canvas.to(self.device), compute_dtype=torch.float32)

    def get_image_embedding(self) -> torch.Tensor:
        """(1, gh, gw, C) fp32 image embedding of the last ``set_image``."""
        if self.features is None:
            raise RuntimeError("set_image() first")
        return self.features

    def _to_model_coords(self, coords: np.ndarray) -> np.ndarray:
        oh, ow = self.original_size
        nh, nw = self.input_size
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= nw / ow
        out[..., 1] *= nh / oh
        return out

    @torch.inference_mode()
    def predict(self, point_coords: np.ndarray | None = None, point_labels: np.ndarray | None = None,
                box: np.ndarray | None = None, mask_input: np.ndarray | None = None,
                multimask_output: bool = True, return_logits: bool = False):
        """Prompt coordinates in ORIGINAL image pixels (predictor.py:104-168);
        ``mask_input`` (4 gh, 4 gw) low-res logits, e.g. a previous call's.
        Returns numpy (masks (N, H, W), iou_predictions (N,), low_res_logits
        (N, 4 gh, 4 gw)); masks bool unless ``return_logits``."""
        feat = self.get_image_embedding()
        if point_coords is not None:
            p = self._to_model_coords(np.atleast_2d(point_coords))
            lbls = np.asarray(point_labels, np.int64).reshape(-1)
        else:
            p, lbls = np.zeros((0, 2), np.float32), np.zeros((0,), np.int64)
        if box is None:
            # one not-a-point pad slot iff no box (prompt_encoder.py:83-87)
            p = np.concatenate([p, np.zeros((1, 2), np.float32)])
            lbls = np.concatenate([lbls, [-1]])
        S, dev = self.variant.img_size, self.device
        sparse = self.pe.embed_points(torch.from_numpy(p[None]).to(dev), torch.from_numpy(lbls[None]).to(dev),
                                      (S, S))
        if box is not None:
            b = self._to_model_coords(np.asarray(box, np.float32).reshape(2, 2)).reshape(1, 4)
            sparse = torch.cat([sparse, self.pe.embed_boxes(torch.from_numpy(b).to(dev), (S, S))], dim=1)
        dense = None
        if mask_input is not None:
            g4 = 4 * self.variant.grid
            mi = torch.from_numpy(np.asarray(mask_input, np.float32).reshape(1, g4, g4, 1))
            dense = self.pe.embed_masks(mi.to(dev))
        low_res, iou = decode(self.pe, self.dec, feat, sparse, dense, multimask_output)
        masks = self._postprocess(low_res[0])
        if not return_logits:
            masks = masks > 0.0
        return masks.cpu().numpy(), iou[0].cpu().numpy(), low_res[0].cpu().numpy()

    def _postprocess(self, low_res: torch.Tensor) -> torch.Tensor:
        """(N, 4 gh, 4 gw) logits -> (N, H, W) at the original size
        (sam.py postprocess_masks: upscale to img_size, crop the pad,
        upscale to the original size)."""
        S = self.variant.img_size
        x = resize_bilinear(low_res[..., None].float(), (S, S))
        nh, nw = self.input_size
        return resize_bilinear(x[:, :nh, :nw], self.original_size)[..., 0]
