"""Where the three backward kernels spend their time, launch by launch.

    python -m catseg_tpu_torch.tools.bwd_phases [--dtype bf16|fp32] [--out profile_out/bwd_phases]

At the train step's shapes (``vitb384()``: 4 crops x 171 COCO-Stuff
classes, so 684 decoder slabs, Swin blocks of (4, 171, 24, 24, 128) and
class layers of (4, 171, 12, 12, 128) on the 2x2-pooled grid, pad_len 256)
and seeded random inputs, runs the decoder backward
(``decoder.decoder_backward``, C entry point ``catseg_decoder_bwd``), one
Swin block's backward (``swin_block.swin_block_backward``, shift 6 with
guidance, ``catseg_swin_block_bwd``) and one class layer's backward
(``class_layer.class_layer_backward``, guided, ``catseg_class_layer_bwd``)
once to warm up, times each call with CUDA events (median of ``REPS``),
then runs each once more under ``torch.profiler`` and reads every kernel of
that call from the exported chrome trace.  Each launch gets a stage: a
category from its kernel's name (``STAGES``, first match), numbered within
the call where the category repeats, the numbers named by the order in
which both the first version and the tensor-core redesign run their stages
(``ORDINALS``: recompute in forward order, then the backward in reverse).
Prints, per entry point, one JSON object: the call's ms, the device time of
its kernels, per stage the launches and device ms, and every launch in
order with its shortened name.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

REPS = 3
ENTRIES = {"decoder": ("catseg_decoder_bwd", "684 slabs"),
           "swin": ("catseg_swin_block_bwd", "(4, 171, 24, 24, 128), shift 6, guided"),
           "class": ("catseg_class_layer_bwd", "(4, 171, 12, 12, 128), guided, pad_len 256")}

# kernel name -> stage category, first match wins
STAGES = {
    "decoder": (
        ("head wgrad", r"head_wgrad|gemm_kernel<128, 16, 8,"),
        ("head dgrad", r"head_dgrad|FlipW<32, 1>"),
        ("GN stats + apply (recompute)", r"gn_stats|gn_apply"),
        ("GN backward", r"gn_bwd"),
        ("weight packing", r"pack_"),
        ("reductions (split partials, guidance, bias)", r"sum_mid"),
        ("wgrad", r"Partial"),
        ("recompute product", r"ConvTEpi|ConvEpi"),
        ("dgrad", r"gemm"),
        ("torch (wrapper casts, copies)", r""),
    ),
    "swin": (
        ("LN forward (recompute)", r"ln_fwd"),
        ("LN backward", r"ln_bwd"),
        ("window attention", r"win_attn"),
        ("weight packing", r"pack_"),
        ("reductions (split partials, guidance, bias)", r"sum_mid"),
        ("wgrad", r"Partial"),
        ("recompute product", r"QkvEpi|ProjEpi|BiasEpi|Fc1Epi"),
        ("dgrad", r"gemm"),
        ("torch (wrapper casts, copies)", r""),
    ),
    "class": (
        ("LN forward (recompute)", r"ln_fwd"),
        ("LN backward", r"ln_bwd"),
        ("linear attention", r"lin_attn"),
        ("weight packing", r"pack_"),
        ("reductions (split partials, pad cotangents, guidance, bias)", r"sum_mid"),
        ("wgrad", r"Partial"),
        ("recompute product", r"QkvEpi|ReluEpi"),
        ("dgrad", r"gemm"),
        ("torch (wrapper casts, copies)", r""),
    ),
}
ORDINALS = {
    "decoder": {
        "recompute product": ("ConvT 1", "conv 11", "conv 12", "ConvT 2", "conv 21", "conv 22"),
        "GN stats + apply (recompute)": ("GN 11", "GN 12", "GN 21", "GN 22"),
        "GN backward": ("GN 22", "GN 21", "GN 12", "GN 11"),
        "wgrad": ("conv 22", "conv 21", "ConvT 2", "conv 12", "conv 11", "ConvT 1"),
        "dgrad": ("conv 22", "conv 21", "ConvT 2", "conv 12", "conv 11", "ConvT 1"),
    },
    "swin": {
        "recompute product": ("qkv", "proj", "fc1"),
        "window attention": ("forward (recompute)", "backward"),
        "LN forward (recompute)": ("LN 1", "LN 2"),
        "LN backward": ("LN 2", "LN 1"),
        "wgrad": ("fc2", "fc1", "proj", "qkv"),
        "dgrad": ("fc2", "fc1", "proj", "qkv"),
    },
    "class": {
        "recompute product": ("qkv", "fc1"),
        "linear attention": ("forward (recompute)", "backward"),
        "LN forward (recompute)": ("LN 1", "LN 2"),
        "LN backward": ("LN 2", "LN 1"),
        "wgrad": ("fc2", "fc1", "qkv"),
        "dgrad": ("fc2", "fc1", "qkv"),
    },
}


def short(name: str) -> str:
    """A kernel's name without namespaces, argument list and ``void``."""
    name = re.sub(r"\(anonymous namespace\)::|catseg::|bwd::|tc::|void ", "", name)
    depth, out = 0, []
    for ch in name:   # drop the trailing argument list, keep template arguments
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:200]


def inputs(dev, dtype: torch.dtype, seed: int = 0):
    """{entry: thunk} of the three backward wrappers on seeded inputs at the
    train step's shapes."""
    from ..kernels import class_layer, decoder, swin_block

    g = torch.Generator().manual_seed(seed)

    def u(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(dev)

    def up(cin, cup, mid):
        return {"up_w": u(cin, cup, 2, 2, bound=(4 * cin) ** -0.5), "up_b": u(cup, bound=0.05),
                "conv1_w": u(mid, cin, 3, 3, bound=(9 * cin) ** -0.5),
                "gn1_g": 1 + u(mid, bound=0.1), "gn1_b": u(mid, bound=0.1),
                "conv2_w": u(mid, mid, 3, 3, bound=(9 * mid) ** -0.5),
                "gn2_g": 1 + u(mid, bound=0.1), "gn2_b": u(mid, bound=0.1)}

    B, T = 4, 171
    d1, d2 = up(128, 96, 64), up(64, 48, 32)
    head = {"w": u(1, 32, 3, 3, bound=(9 * 32) ** -0.5), "b": u(1, bound=0.1)}
    p = dict(zip(decoder._DK, decoder._params(d1, d2, head)))
    xd = torch.randn(B * T, 24, 24, 128, generator=g).to(dev, dtype)
    hg1 = decoder._guidance_half(d1, (torch.randn(B, 48, 48, 32, generator=g) * 0.5).to(dev), 96, dtype)
    hg2 = decoder._guidance_half(d2, (torch.randn(B, 96, 96, 16, generator=g) * 0.5).to(dev), 48, dtype)
    dd = torch.randn(B * T, 96, 96, generator=g).to(dev)
    C = 128
    ps = {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "qkv_w": u(C, 3 * C),
          "qkv_b": u(3 * C, bound=0.1), "proj_w": u(C, C), "proj_b": u(C, bound=0.1),
          "ln2_g": 1 + u(C, bound=0.1), "ln2_b": u(C, bound=0.1), "fc1_w": u(C, 4 * C),
          "fc1_b": u(4 * C, bound=0.1), "fc2_w": u(4 * C, C), "fc2_b": u(C, bound=0.1)}
    xs = torch.randn(B, T, 24, 24, C, generator=g).to(dev, dtype)
    qg, kg = ((torch.randn(B, 24, 24, C, generator=g) * 0.5).to(dev, dtype) for _ in range(2))
    ds = torch.randn(B, T, 24, 24, C, generator=g).to(dev, dtype)
    cp = {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "q_w": u(2 * C, C), "q_b": u(C),
          "k_w": u(2 * C, C), "k_b": u(C), "v_w": u(C, C), "v_b": u(C), "ln2_g": 1 + u(C, bound=0.1),
          "ln2_b": u(C, bound=0.1), "mlp1_w": u(C, 4 * C), "mlp1_b": u(4 * C), "mlp2_w": u(4 * C, C),
          "mlp2_b": u(C)}
    Tp = 256
    xc = torch.randn(B, T, 12, 12, C, generator=g).to(dev, dtype)
    qc, kc = ((torch.randn(B, T, C, generator=g) * 0.3).to(dev, dtype) for _ in range(2))
    pkv, pks = class_layer.pad_contributions(torch.randn(C, generator=g).to(dev),
                                             torch.randn(C, generator=g).to(dev), cp, Tp - T, Tp, 4)
    dc = torch.randn(B, T, 12, 12, C, generator=g).to(dev, dtype)
    kp = class_layer.kernel_params(cp)
    return {"decoder": lambda: decoder.decoder_backward(xd, hg1, hg2, dd, p),
            "swin": lambda: swin_block.swin_block_backward(xs, qg, kg, ds, ps, 4, 12, 6),
            "class": lambda: class_layer.class_layer_backward(xc, qc, kc, pkv, pks, dc, kp, 4, Tp)}


def call_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def launches(fn, trace_path: Path) -> list[tuple[str, float]]:
    """(kernel name, device ms) of every kernel one call of fn runs, in order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = [ev for ev in json.loads(trace_path.read_text())["traceEvents"] if ev.get("cat") == "kernel"]
    return [(ev["name"], ev["dur"] / 1e3) for ev in sorted(events, key=lambda ev: ev["ts"])]


def stages(kind: str, seq: list[tuple[str, float]]) -> tuple[dict, list]:
    """Per stage {launches, ms} in first-seen order, and the labelled launches."""
    per: dict[str, dict] = {}
    seen: dict[str, int] = {}
    rows = []
    for name, ms in seq:
        cat = next(c for c, pat in STAGES[kind] if re.search(pat, name))
        i = seen.get(cat, 0)
        seen[cat] = i + 1
        names = ORDINALS[kind].get(cat)
        label = f"{cat}: {names[i]}" if names and i < len(names) else cat
        per.setdefault(label, {"launches": 0, "ms": 0.0})
        per[label]["launches"] += 1
        per[label]["ms"] += ms
        rows.append({"stage": label, "ms": ms, "kernel": short(name)})
    return per, rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--out", default="profile_out/bwd_phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_phases needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = []
    for kind, fn in inputs(torch.device("cuda"), dtype).items():
        fn()
        torch.cuda.synchronize()
        ms = call_ms(fn)
        seq = launches(fn, out / f"trace_{kind}_bwd.json")
        per, rows = stages(kind, seq)
        entry, shapes = ENTRIES[kind]
        r = {"card": card, "entry": entry, "dtype": args.dtype, "shapes": shapes, "call_ms": ms,
             "device_ms": sum(m for _, m in seq), "launches": len(seq),
             "stages": {k: v for k, v in sorted(per.items(), key=lambda kv: -kv[1]["ms"])}, "sequence": rows}
        (out / f"bwd_phases_{kind}_{args.dtype}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps({k: v for k, v in r.items() if k != "sequence"}))
        res.append(r)
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()
