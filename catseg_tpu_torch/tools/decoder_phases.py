"""Where the bf16 decoder kernel (#8) spends a slab's time, stage by stage.

    python -m catseg_tpu_torch.tools.decoder_phases [--reps 5]

Builds csrc/decoder.cu once more as a timing build (into
``catseg_tpu_torch/_build/decoder_phases/<hash>/``, never the port's
library) with CATSEG_DEC_PHASE_CLOCKS: thread 0 of every CTA adds the
clock64 cycles of each stage of each slab it walks.  Runs the decoder on the
serving slice's 1500 slabs (10 tiles x 150 classes, bf16, both guidance
planes) through the port's kernel and the timing build on the same prepared
arguments, and prints one JSON line per build: the launch's ms (median of
``--reps`` CUDA-event timings; for the port's build also ``wrapper_ms``, the
call as the model makes it, weights cast and packed inside the timed window)
and, per stage, the mean cycles a slab, its share of the slab's time and the
cycles its tensor-core work would take at the SM's dense bf16 peak.  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import _build, decoder
from .swin_phases import SM_FLOPS_PER_CYCLE, cycles, time_ms, timing_builds

PHASES = ("convt1", "conv1", "conv2", "convt2", "conv3", "conv4", "head")
# a slab's tensor-core operations per stage (the head runs on CUDA cores)
FLOPS = {"convt1": 2 * 576 * 128 * 384, "conv1": 2 * 2304 * 864 * 64, "conv2": 2 * 2304 * 576 * 64,
         "convt2": 2 * 2304 * 64 * 192, "conv3": 2 * 9216 * 432 * 32, "conv4": 2 * 9216 * 288 * 32}


def inputs(dev, images: int = 10, classes: int = 150, seed: int = 0):
    """The serving slice's slabs (images x classes, 24 x 24 x 128) in bf16,
    the per-image guidance halves of conv1 and the decoder's parameters
    (the fused Function's flat layout), from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, bound):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(dev)

    def up(cin, cup, mid):
        return {"up_w": u(cin, cup, 2, 2, bound=(4 * cin) ** -0.5), "up_b": u(cup, bound=0.05),
                "conv1_w": u(mid, cin, 3, 3, bound=(9 * cin) ** -0.5),
                "gn1_g": 1 + u(mid, bound=0.1), "gn1_b": u(mid, bound=0.1),
                "conv2_w": u(mid, mid, 3, 3, bound=(9 * mid) ** -0.5),
                "gn2_g": 1 + u(mid, bound=0.1), "gn2_b": u(mid, bound=0.1)}

    d1, d2 = up(128, 96, 64), up(64, 48, 32)
    head = {"w": u(1, 32, 3, 3, bound=(9 * 32) ** -0.5), "b": u(1, bound=0.1)}
    x = torch.randn(images * classes, 24, 24, 128, generator=g).to(dev, torch.bfloat16)
    g1 = (torch.randn(images, 48, 48, 32, generator=g) * 0.5).to(dev, torch.bfloat16)
    g2 = (torch.randn(images, 96, 96, 16, generator=g) * 0.5).to(dev, torch.bfloat16)
    hg1 = decoder._guidance_half(d1, g1, 96, torch.bfloat16)
    hg2 = decoder._guidance_half(d2, g2, 48, torch.bfloat16)
    return x, (g1, g2, d1, d2, head), hg1, hg2, dict(zip(decoder._DK, decoder._params(d1, d2, head)))


def measure(reps: int) -> list[dict]:
    dev = torch.device("cuda")
    libs = timing_builds("decoder", {"clocks": ("-DCATSEG_DEC_PHASE_CLOCKS",)}, "catseg_decoder",
                         "catseg_decoder_phase_cycles")
    x, (g1, g2, d1, d2, head), hg1, hg2, p = inputs(dev)
    _, args = decoder.decoder_args(x, hg1, hg2, p)
    port_ms = time_ms(lambda: _build.launch("catseg_decoder", *args), reps)
    wrapper_ms = time_ms(lambda: decoder.fused_decoder(x, g1, g2, d1, d2, head), reps)
    rows = [{"build": "port", "slabs": x.shape[0], "ms": port_ms, "wrapper_ms": wrapper_ms}]
    for name, lib in libs.items():
        run = lambda: _build.launch("catseg_decoder", *args, lib=lib)  # noqa: E731
        run()
        torch.cuda.synchronize()
        cycles(lib, len(PHASES), "catseg_decoder_phase_cycles")
        ms = time_ms(run, reps)
        sums = cycles(lib, len(PHASES), "catseg_decoder_phase_cycles")
        slabs = sums[-1]
        per = [s / slabs for s in sums[:-1]]
        total = sum(per)
        rows.append({
            "build": name, "ms": ms, "slabs": slabs, "cycles_per_slab": total,
            "phases": {ph: {"cycles": c, "share": c / total,
                            "tc_peak_cycles": FLOPS[ph] / SM_FLOPS_PER_CYCLE if ph in FLOPS else None}
                       for ph, c in zip(PHASES, per)}})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decoder_phases needs an NVIDIA GPU")
    for row in measure(args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
