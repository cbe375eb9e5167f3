"""Where the bf16 class-layer kernel (#6) spends a position's time, phase by phase.

    python -m catseg_tpu_torch.tools.class_phases [--reps 5] [--classes 150,256]

Builds csrc/class_layer.cu once more as a timing build (into
``catseg_tpu_torch/_build/class_layer_phases/<hash>/``, never the port's
library) with CATSEG_CLASS_PHASE_CLOCKS: thread 0 of every CTA adds the
clock64 cycles between the kernel's barriers, per phase, the four heads'
phases summed.  Runs one layer at the serving slab (10 tiles x T classes on
the 24 x 24 grid, bf16, guidance, pad_len 256) through the port's kernel and
the timing build on the same prepared arguments, and prints one JSON line
per (build, T): the launch's ms (median of ``--reps`` CUDA-event timings;
for the port's build also ``wrapper_ms``, the call as the model makes it,
weights cast and packed inside the timed window) and, per phase, the mean
cycles a CTA, its share of the CTA's time and, for the products, the cycles
their tensor-core work would take at the SM's dense bf16 peak.  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import _build, class_layer
from .swin_phases import SM_FLOPS_PER_CYCLE, cycles, time_ms, timing_builds

PHASES = ("load_ln1", "kv", "kv_reduce", "q", "attn_out", "ln2", "fc1", "fc2", "epilogue_store")
C, HID, HEADS, PAD = 128, 512, 4, 256


def flops(T: int) -> dict[str, float]:
    """A position's tensor-core operations per phase (T rows padded to 16)."""
    tp = (T + 15) // 16 * 16
    return {"kv": 2 * tp * C * 2 * C, "q": 2 * tp * C * C, "fc1": 2 * tp * C * HID, "fc2": 2 * tp * HID * C}


def inputs(dev, T: int, seed: int = 0):
    """The serving slab (10 tiles, T classes, 24 x 24, 128) in bf16, its
    guidance rows, the padding terms and one layer's parameters, from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(dev)

    p = {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "q_w": u(2 * C, C), "q_b": u(C),
         "k_w": u(2 * C, C), "k_b": u(C), "v_w": u(C, C), "v_b": u(C), "ln2_g": 1 + u(C, bound=0.1),
         "ln2_b": u(C, bound=0.1), "mlp1_w": u(C, HID), "mlp1_b": u(HID), "mlp2_w": u(HID, C), "mlp2_b": u(C)}
    x = torch.randn(10, T, 24, 24, C, generator=g).to(dev, torch.bfloat16)
    qg, kg = ((torch.randn(10, T, C, generator=g) * 0.3).to(dev, torch.bfloat16) for _ in range(2))
    pkv, pks = class_layer.pad_contributions(torch.randn(C, generator=g).to(dev),
                                             torch.randn(C, generator=g).to(dev), p, PAD - T, PAD, HEADS)
    return x, qg, kg, pkv, pks, p


def measure(reps: int, classes) -> list[dict]:
    dev = torch.device("cuda")
    libs = timing_builds("class_layer", {"clocks": ("-DCATSEG_CLASS_PHASE_CLOCKS",)}, "catseg_class_layer",
                         "catseg_class_phase_cycles")
    rows = []
    for T in classes:
        x, qg, kg, pkv, pks, p = inputs(dev, T)
        kp = class_layer.kernel_params(p)
        _, args = class_layer.layer_args(x, qg, kg, pkv, pks, kp, PAD)
        port_ms = time_ms(lambda: _build.launch("catseg_class_layer", *args), reps)
        wrapper_ms = time_ms(lambda: class_layer.fused_class_layer(x, qg, kg, pkv, pks, p, HEADS, PAD), reps)
        rows.append({"build": "port", "T": T, "ms": port_ms, "wrapper_ms": wrapper_ms})
        fl = flops(T)
        for name, lib in libs.items():
            run = lambda: _build.launch("catseg_class_layer", *args, lib=lib)  # noqa: E731
            run()
            torch.cuda.synchronize()
            cycles(lib, len(PHASES), "catseg_class_phase_cycles")
            ms = time_ms(run, reps)
            sums = cycles(lib, len(PHASES), "catseg_class_phase_cycles")
            ctas = sums[-1]
            per = [s / ctas for s in sums[:-1]]
            total = sum(per)
            rows.append({
                "build": name, "T": T, "ms": ms, "ctas": ctas, "cycles_per_cta": total,
                "phases": {ph: {"cycles": c, "share": c / total,
                                "tc_peak_cycles": fl[ph] / SM_FLOPS_PER_CYCLE if ph in fl else None}
                           for ph, c in zip(PHASES, per)}})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--classes", default="150,256", help="comma-separated class counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("class_phases needs an NVIDIA GPU")
    for row in measure(args.reps, [int(t) for t in args.classes.split(",")]):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
