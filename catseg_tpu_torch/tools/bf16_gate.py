"""The bf16 serving path against fp32 on the card, held to the reference's bounds.

    python -m catseg_tpu_torch.tools.bf16_gate [--seed N] [--scan 0,1,...]
        [--control no-guidance,mantissa:4,...]

Mirrors tests/test_fullscale_parity_more.py::test_bf16_drift_fullscale, the
reference's own bound on its production dtype: one seeded 427x640 image and
150 random unit text features (``np.random.RandomState(3)``) through the same
seeded weights at ``eval_preset(vitb384(compute_dtype=dt))`` for fp32 and
bf16, ``Predictor.probs_sliding_batch`` on the card both ways.  Bounds: max
|d prob| < 0.02, mean < 2e-3, and argmax agreement > 0.99 on the pixels whose
fp32 top-2 gap exceeds 0.01, of which there must be some.

The agreement bound reads only pixels the fp32 model decides.  The port's
seed-0 and seed-1 random models decide none of the 409,600 (no top-2 gap
above 0.01), so the gate would hold nothing there; ``GATE_SEED`` is the
first seed whose fp32 model decides at least 1000, found by ``--scan`` from
the fp32 gaps alone (PERF.md).  chip_smoke.py phase [14] runs
:func:`readings` at ``GATE_SEED``; ``--scan`` prints each seed's fp32 gaps.
Architecture fields of ``vitb384`` go to :func:`readings` as keywords:
phase [46] runs the gate at ``hidden_dim=256``.

``--control`` reads the gate on bf16 runs made worse on purpose, to show
what it can catch: ``no-guidance`` drops the appearance guidance from both
Swin pairs (a kernel that skipped the guidance add), ``mantissa:N`` rounds
each Swin pair's output to N mantissa bits (bf16 keeps 7), a kernel that
lost precision.  Only this tool's process is changed; the port is not.
Needs an NVIDIA GPU; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

GATE_SEED = 2
T = 150
BOUND_MAX, BOUND_MEAN, BOUND_AGREE, DECIDED_GAP = 0.02, 2e-3, 0.99, 0.01


def _inputs():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (427, 640, 3)).astype(np.float32)
    text = rng.randn(T, 1, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return img, text


def probs(dtype: str, seed: int, **arch) -> tuple[np.ndarray, dict]:
    """(640, 640, T) probabilities of one dtype's run of
    ``eval_preset(vitb384(compute_dtype=dtype, **arch))``, and the kernel
    launches it made (counts set to 0 just before)."""
    from ..configs import eval_preset, vitb384
    from ..core.catseg import build_catseg
    from ..infer.pipeline import Predictor
    from ..kernels import _build

    img, text = _inputs()
    cfg = eval_preset(vitb384(compute_dtype=dtype, **arch))
    pred = Predictor(build_catseg(cfg, seed=seed), cfg, [f"c{i}" for i in range(T)], text_feats=text)
    torch.cuda.synchronize()
    _build.reset_launches()
    p = pred.probs_sliding_batch([img])[0].float().cpu().numpy()
    launches = dict(_build.LAUNCHES)
    del pred
    torch.cuda.empty_cache()
    return p, launches


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """t rounded to ``bits`` explicit mantissa bits (half away from zero in
    magnitude), in t's dtype."""
    drop = 23 - bits
    i = t.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & -(1 << drop)
    return i.view(torch.float32).to(t.dtype)


@contextlib.contextmanager
def control(spec: str):
    """The aggregator's Swin pair made worse on purpose while the block runs
    (``no-guidance`` or ``mantissa:N``, see the module's note)."""
    from ..core import aggregator

    pair = aggregator.fused_swin_pair
    if spec == "no-guidance":
        def worse(x, guid4, *a):
            return pair(x, None, *a)
    elif spec.startswith("mantissa:"):
        bits = int(spec.split(":")[1])

        def worse(x, guid4, *a):
            return round_mantissa(pair(x, guid4, *a), bits)
    else:
        raise ValueError(f"unknown control {spec!r}")
    aggregator.fused_swin_pair = worse
    try:
        yield
    finally:
        aggregator.fused_swin_pair = pair


def _decided(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    srt = np.sort(a, axis=-1)
    gap = srt[..., -1] - srt[..., -2]
    return gap, gap > DECIDED_GAP


def readings(seed: int = GATE_SEED, fp32: np.ndarray | None = None, **arch) -> dict:
    """The gate's readings at ``seed`` (``fp32``: that seed's fp32
    probabilities, if already made) for the architecture ``arch``; ``ok``
    says whether all three bounds hold over a non-empty decided set."""
    a = probs("float32", seed, **arch)[0] if fp32 is None else fp32
    b, launches = probs("bfloat16", seed, **arch)
    d = np.abs(a - b)
    _, decided = _decided(a)
    same = a.argmax(-1) == b.argmax(-1)
    agree = float(same[decided].mean()) if decided.any() else 0.0
    r = {"seed": seed, "max_abs_dprob": float(d.max()), "mean_abs_dprob": float(d.mean()),
         "decided_pixels": int(decided.sum()), "pixels": int(decided.size), "decided_agreement": agree,
         "all_agreement": float(same.mean()), "bf16_launches": launches}
    r["ok"] = bool(d.max() < BOUND_MAX and d.mean() < BOUND_MEAN and decided.any() and agree > BOUND_AGREE)
    return r


def fp32_gaps(seed: int) -> dict:
    gap, decided = _decided(probs("float32", seed)[0])
    return {"seed": seed, "decided_pixels": int(decided.sum()), "gap_max": float(gap.max()),
            "gap_median": float(np.median(gap))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=GATE_SEED)
    ap.add_argument("--scan", help="comma-separated seeds: print each fp32 model's top-2 gaps instead")
    ap.add_argument("--control", help="comma-separated: also read the gate on each bf16 run made worse so")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_gate needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.scan:
        for s in args.scan.split(","):
            print(json.dumps(fp32_gaps(int(s))), flush=True)
        return
    fp32 = probs("float32", args.seed)[0]
    print(json.dumps(readings(args.seed, fp32)), flush=True)
    for spec in args.control.split(",") if args.control else ():
        with control(spec):
            r = readings(args.seed, fp32)
        print(json.dumps({"control": spec, **r}), flush=True)


if __name__ == "__main__":
    main()
