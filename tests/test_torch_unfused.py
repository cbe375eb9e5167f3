"""The aggregator's unfused stages and their three kernels against catseg_tpu,
on the CPU.

The window-attention, MLP and linear-attention modules' plain versions (what
their wrappers run for CPU tensors) take the same numpy inputs as the JAX
functions, which run as catseg_tpu's own tests run them here: the Pallas body
in interpret mode where its gate holds (window attention always; the MLP at
C = 128, H = 512, M >= 1024, with a ragged last tile, and at C = 512, H =
2048, where C * H is the gate's 2^20; linear attention at S % 8 == 0), its
``_reference`` elsewhere.  Each Function's gradients are held to
``jax.vjp``, and the port's ``aggregator_forward`` to catseg_tpu's at the
JAX parity test's own small configuration (hidden 32, window 4, 8x8 grid,
pool 2, pad_len 8; tests/test_aggregator_parity.py), where every stage takes
the unfused route, and at the mini vitb384 of test_torch_aggregator.py with
``attention_type="full"``.

Tolerances.  fp32 kernels: 3e-5 abs (summation order; the reference's fp32
GELU is a 1.5e-5-accurate polynomial, the port uses erf).  bf16: both sides
round the same fp32 quantities to bf16, so they differ by an ulp where the
fp32 summation order tips a rounding: 2^-7 of max(1, |out|) covers two ulps
of the outputs here, and fails if a fast-form gate (tanh GELU) is keyed
differently.  Gradients (fp32): 1e-4 of max(1, |jax|).  Aggregators: the JAX
parity test's own 5e-4 abs and 1e-3 rel; the mini model 1e-4 abs, as
test_torch_aggregator.py.

The routes (``selfcheck.ROUTES``, geometries some kernels do not take): the
aggregator calls exactly the kernel wrappers ROUTES names (no route picks a
plain version instead), those outside their kernel's ``kernel_takes`` split
exactly into the ones ROUTES says raise on the card and the ones it says run
plain there (the MLP's and linear attention's ``route``: the reference's
own gate fails), and every call inside hands the kernel rows laid out as
its CUDA path takes them; and the mini model at hidden 256, at one head, at
hidden 192 with 3 heads, at hidden 512, at hidden 384 with 3 and 4
heads, at one head of 256, at hidden 96 and 100 and at window 24 matches
catseg_tpu's on the CPU.  The MLP's, linear attention's and the LayerNorm's decision
(kernel, plain or raise) is checked against a table of geometries at the
edges of their gates.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core import aggregator as jagg
from catseg_tpu.kernels import layer_norm as jln
from catseg_tpu.kernels import linear_attn as jla
from catseg_tpu.kernels import mlp as jmlp
from catseg_tpu.kernels import window_attn as jwa
from catseg_tpu.weights.convert import convert_aggregator_state_dict
from catseg_tpu.weights.export import export_aggregator_state_dict

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import aggregator as tagg
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.kernels import class_layer, corr_embed, decoder, selfcheck, swin_block
from catseg_tpu_torch.kernels import layer_norm as tln
from catseg_tpu_torch.kernels import linear_attn as tla
from catseg_tpu_torch.kernels import mlp as tmlp
from catseg_tpu_torch.kernels import window_attn as twa

from test_aggregator_parity import PAD_LEN, P, _agg_state_dict, _cfg, _inputs
from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's small CPU ops on one thread: under the suite's parallel
    workers its thread pool oversubscribes the cores and stalls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(a, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dt):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    bound = 3e-5 if dt == "float32" else 2 ** -7 * max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= bound, (err, bound)


def _mlp_inputs(M, C, H, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, C).astype(np.float32) * 0.5, rng.randn(C, H).astype(np.float32) * 0.1,
            rng.randn(H).astype(np.float32) * 0.1, rng.randn(H, C).astype(np.float32) * 0.1,
            rng.randn(C).astype(np.float32) * 0.1)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,M,C", [("gelu", 1024, 128), ("relu", 1324, 128), ("gelu", 64, 32),
                                     ("gelu", 1024, 512)],
                         ids=["gelu-pallas", "relu-pallas-ragged", "gelu-reference", "gelu-pallas-512"])
def test_mlp_plain_matches_jax(dt, act, M, C):
    x, w1, b1, w2, b2 = _mlp_inputs(M, C, 4 * C)
    jx, tx = _pair(x, dt)
    w = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    want = jmlp.fused_mlp(jx, *w, act)
    got = tmlp.fused_mlp(tx, *(torch.from_numpy(a) for a in (w1, b1, w2, b2)), act)
    assert got.dtype == DTYPES[dt][1]
    _check(got, want, dt)


def _window_inputs(H, win, C, seed=1):
    rng = np.random.RandomState(seed)
    Bw = 2 * (H // win) ** 2
    return tuple(rng.randn(Bw, win * win, C).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,win,C,heads", [(8, 4, 32, 4), (24, 12, 128, 4), (24, 12, 128, 1), (12, 12, 96, 4),
                                           (12, 12, 192, 4), (12, 12, 384, 4), (8, 4, 256, 1), (12, 12, 100, 4)],
                         ids=["win4-C32", "win12-C128", "win12-C128-heads1", "win12-C96", "win12-C192",
                              "win12-C384", "win4-C256-heads1", "win12-C100"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_window_attention_plain_matches_jax(dt, H, win, C, heads, shifted):
    """Head dims 8, 32, (one head of 128) 128, and the ones the kernel took
    last: 24, 48, 96 (hidden 96, 192 and 384 at 4 heads), one head of 256,
    and 25 (hidden 100, rows of 100 elements); the reference's Pallas
    kernel in interpret mode, a few windows each."""
    q, k, v = _window_inputs(H, win, C)
    N = win * win
    mask = (np.array(jagg._shift_mask(H, H, win, win // 2)) if shifted
            else np.zeros(((H // win) ** 2, N, N), np.float32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    scale = (C // heads) ** -0.5
    assert twa.kernel_takes(N, C, heads)
    want = jwa.fused_window_attention(jq, jk, jv, jnp.asarray(mask), heads, scale)
    got = twa.fused_window_attention(tq, tk, tv, torch.from_numpy(mask), heads, scale)
    _check(got, want, dt)


def test_shift_mask_matches_jax():
    from catseg_tpu_torch.kernels.swin_block import shift_mask

    for H, win in ((8, 4), (24, 12)):
        np.testing.assert_array_equal(shift_mask(H, H, win, win // 2).numpy(),
                                      np.asarray(jagg._shift_mask(H, H, win, win // 2)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,S,heads", [(128, 16, 4), (128, 13, 4), (128, 16, 1), (384, 16, 4), (384, 16, 16),
                                       (256, 16, 1)],
                         ids=["pallas", "reference", "pallas-heads1", "pallas-C384", "pallas-C384-heads16",
                              "pallas-C256-heads1"])
def test_linear_attention_plain_matches_jax(dt, C, S, heads):
    """Head dim 32, 128 (one head of C = 128: the port's kernel takes it,
    and the reference runs its Pallas kernel at S = 16), and head dims 96,
    24 and 256 at C = 384 and 256, where the reference's gate runs its
    Pallas kernel and the port's takes them on its CUDA-core path."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(6, S, C).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    assert tla.route(C, heads, S) == "kernel"
    want = jla.fused_linear_attention(jq, jk, jv, heads)
    got = tla.fused_linear_attention(tq, tk, tv, heads)
    _check(got, want, dt)


def _vjp_cases():
    """name -> (numpy inputs, jax fn, port fn) over the differentiable inputs."""
    x, w1, b1, w2, b2 = _mlp_inputs(1024, 128, 512, seed=3)
    q, k, v = _window_inputs(8, 4, 32, seed=4)
    mask = np.array(jagg._shift_mask(8, 8, 4, 2))
    rng = np.random.RandomState(5)
    ql, kl, vl = (rng.randn(4, 16, 128).astype(np.float32) for _ in range(3))
    return {
        "mlp": ((x, w1, b1, w2, b2), lambda *a: jmlp.fused_mlp(*a, "gelu"),
                lambda *a: tmlp.fused_mlp(*a, "gelu")),
        "window_attention": ((q, k, v), lambda *a: jwa.fused_window_attention(*a, jnp.asarray(mask), 4, 8 ** -0.5),
                             lambda *a: twa.fused_window_attention(*a, torch.from_numpy(mask), 4, 8 ** -0.5)),
        "linear_attention": ((ql, kl, vl), lambda *a: jla.fused_linear_attention(*a, 4),
                             lambda *a: tla.fused_linear_attention(*a, 4)),
    }


@pytest.mark.parametrize("name", ["mlp", "window_attention", "linear_attention"])
def test_unfused_kernel_grads_match_jax(name):
    inputs, jfn, tfn = _vjp_cases()[name]
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in inputs))
    g = np.random.RandomState(6).randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = tfn(*ts)
    assert got.grad_fn is not None and type(got.grad_fn).__name__.endswith("FnBackward")
    got.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        w = np.asarray(w)
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), (name, err)


def _port_cfg(jcfg):
    """The port's config with the JAX one's aggregator fields."""
    skip = {"clip", "fusion"}
    return tconfigs.CATSegConfig(**{f.name: getattr(jcfg, f.name)
                                    for f in dataclasses.fields(tconfigs.CATSegConfig) if f.name not in skip})


@pytest.fixture(scope="module")
def small_sd():
    return _agg_state_dict()


@pytest.mark.parametrize("T,attn", [(5, "linear"), (PAD_LEN, "linear"), (13, "linear"), (5, "full")])
def test_small_aggregator_matches_jax(small_sd, T, attn):
    """Every stage of the JAX parity test's small configuration takes the
    unfused route: hidden 32 is outside the fused kernels, "full" always."""
    jcfg = _cfg(attention_type=attn)
    tcfg = _port_cfg(jcfg)
    params = convert_aggregator_state_dict({k: t.numpy() for k, t in small_sd.items()}, num_layers=2)
    agg = tagg.Aggregator(tcfg)
    agg.conv1 = tagg.Conv(P, tcfg.hidden_dim, 7)   # the parity test's P = 2 prompt templates
    agg.load_state_dict(small_sd, strict=True)
    img, txt, guid = _inputs(T)
    want = np.asarray(jagg.aggregator_forward(params, jnp.asarray(img), jnp.asarray(txt),
                                              tuple(map(jnp.asarray, guid)), jcfg))
    with torch.no_grad():
        got = tagg.aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                      tuple(map(torch.from_numpy, guid)), tcfg).numpy()
    assert got.shape == want.shape == (2, T, 32, 32)
    if T > PAD_LEN:
        # top-k ties may order differently: compare the kept classes only
        sel_g, sel_w = got > -100.0, want > -100.0
        np.testing.assert_array_equal(sel_g, sel_w)
        got, want = got[sel_g], want[sel_w]
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_mini_full_attention_matches_jax():
    """The mini vitb384 of test_torch_aggregator.py with attention_type="full":
    the fused Swin pair, then the unfused class stage with the MLP kernel."""
    params = mini_params()
    cfg, tcfg = mini_cfg(attention_type="full"), mini_cfg_port(attention_type="full")
    agg = tagg.Aggregator(tcfg)
    agg.load_state_dict({k: torch.tensor(v) for k, v in export_aggregator_state_dict(params["agg"]).items()},
                        strict=True)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 24, 24, 64).astype(np.float32)
    txt = rng.randn(1, 6, 1, 64).astype(np.float32)
    guid = (rng.randn(1, 24, 24, 64).astype(np.float32), rng.randn(1, 48, 48, 256).astype(np.float32),
            rng.randn(1, 96, 96, 128).astype(np.float32))
    want = jagg.aggregator_forward(params["agg"], jnp.asarray(img), jnp.asarray(txt),
                                   tuple(jnp.asarray(g) for g in guid), cfg)
    with torch.no_grad():
        got = tagg.aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                      tuple(torch.from_numpy(g) for g in guid), tcfg)
    assert got.shape == (1, 6, 96, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_routing_by_geometry(monkeypatch):
    """Hidden 128 / window 12 / linear takes the fused stages; hidden 32, T
    past the class kernel and "full" take the unfused ones."""
    flagship = tconfigs.eval_preset(tconfigs.vitb384())
    small = _port_cfg(_cfg())
    slab = (1, 150, 24, 24, 128)
    assert tagg.swin_route_fused(slab, flagship) and tagg.class_route_fused(slab, flagship)
    assert tagg.class_route_fused(slab, tconfigs.vitb384())        # train pooling (2, 2)
    assert not tagg.class_route_fused(slab, flagship.replace(attention_type="full"))
    assert not tagg.class_route_fused((1, 257, 24, 24, 128), flagship.replace(pad_len=0))
    assert not tagg.swin_route_fused(slab, flagship.replace(window_size=8))
    assert not tagg.swin_route_fused((2, 5, 8, 8, 32), small)
    assert not tagg.class_route_fused((2, 5, 8, 8, 32), small)

    def refuse(*a, **k):
        raise AssertionError("the fused stage ran")

    monkeypatch.setattr(tagg, "fused_swin_pair", refuse)
    monkeypatch.setattr(tagg, "fused_class_layer", refuse)
    agg = tagg.Aggregator(small)
    agg.conv1 = tagg.Conv(P, small.hidden_dim, 7)
    agg.load_state_dict(_agg_state_dict(), strict=True)
    img, txt, guid = _inputs(5)
    with torch.no_grad():
        out = tagg.aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                      tuple(map(torch.from_numpy, guid)), small)
    assert out.shape == (2, 5, 32, 32) and torch.isfinite(out).all()


@pytest.mark.parametrize("pool", [(1, 1), (2, 2)], ids=["pool1", "pool2"])
def test_unfused_stages_match_fused_routes(pool):
    """At the flagship geometry, where both routes run, the unfused Swin pair
    and linear class stage compute what the fused ones do (catseg_tpu's
    tests/test_kernels.py holds its own so), fp32, through the plain versions
    on the CPU; bound 2e-4 of max(1, |fused|), as phase [13] of chip_smoke.py."""
    cfg = tconfigs.vitb384(pooling_size=pool, pad_len=8, compute_dtype="float32")
    agg = tagg.Aggregator(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in agg.named_parameters():
            u = torch.rand(p.shape, generator=g) * 2 - 1
            p.copy_(1 + 0.1 * u if name.endswith("norm1.weight") or name.endswith("norm2.weight")
                    else u * (p.shape[1] ** -0.5 if p.ndim == 2 else 0.1))
    layer = agg.layers[0]
    x = torch.randn(1, 5, 24, 24, 128, generator=g)
    ag = torch.randn(1, 24, 24, 128, generator=g) * 0.5
    tg = torch.relu(torch.randn(1, 5, 128, generator=g)) * 0.3
    assert tagg.swin_route_fused(x.shape, cfg) and tagg.class_route_fused(x.shape, cfg)
    with torch.no_grad():
        pairs = [(tagg.spatial_aggregation(x, ag, layer, cfg), tagg.swin_pair_unfused(x, ag, layer, cfg)),
                 (tagg.class_aggregation(x, tg, layer, cfg), tagg.class_layer_unfused(x, tg, layer, cfg))]
    for fused, unfused in pairs:
        err = (unfused - fused).abs().max().item()
        assert err <= 2e-4 * max(1.0, fused.abs().max().item()), err


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


# aggregator attribute: (kernel, whether its CUDA path takes the call's
# geometry, whether it takes the call's layout after the wrapper's own copies,
# and for a call it does not take, whether the card runs it plain)
WRAPPER_TAKES = {
    "fused_corr_embed": ("corr_embed", lambda img, txt, w, b: corr_embed.kernel_takes(
        img.shape[1], img.shape[2], txt.shape[2], w.shape[-1], img.shape[-1]),
        lambda img, txt, w, b: _aligned(img.contiguous(), txt.contiguous()), lambda *_: False),
    "fused_swin_pair": ("swin_block", lambda x, guid4, p1, p2, heads, win: swin_block.kernel_takes(
        x.shape[-1], heads, win, x.shape[2], x.shape[3]),
        lambda x, guid4, *_: _aligned(x.contiguous(), *(guid4 or ())), lambda *_: False),
    "fused_class_layer": ("class_layer", lambda x, qg, kg, pkv, pks, p, heads, Tp: class_layer.kernel_takes(
        x.shape[-1], heads, x.shape[1]), lambda x, qg, kg, *_: _aligned(x.contiguous(), qg, kg), lambda *_: False),
    "fused_decoder": ("decoder", lambda x, g1, g2, d1, d2, head: decoder.decoder_kernel_applicable(x, d1, d2),
                      lambda *_: True, lambda *_: False),
    "fused_window_attention": ("window_attention", lambda q, k, v, mask, heads, scale: twa.kernel_takes(
        q.shape[1], q.shape[2], heads), lambda *_: True, lambda *_: False),   # any row stride
    "fused_mlp": ("mlp", lambda x, w1, b1, w2, b2, act: tmlp.kernel_takes(w1.shape[0], w1.shape[1], w2.shape[1]),
                  lambda x, w1, *_: _aligned(x.reshape(-1, w1.shape[0]).contiguous()),
                  lambda x, w1, b1, w2, b2, act: tmlp.route(*w1.shape, w2.shape[1], x.numel() // w1.shape[0])
                  == "plain"),
    "fused_linear_attention": ("linear_attention", lambda q, k, v, heads: tla.kernel_takes(q.shape[-1], heads),
                               lambda q, k, v, heads: _aligned(*(t.contiguous() for t in (q, k, v))),
                               lambda q, k, v, heads: tla.route(q.shape[-1], heads, q.shape[1]) == "plain"),
}


@pytest.mark.parametrize("name", list(selfcheck.ROUTES))
def test_routes_call_kernels_where_the_reference_does(monkeypatch, name):
    """Over a grid of (hidden, heads, E, window, grid), the aggregator's
    routes call exactly the kernel wrappers ROUTES names; of those whose
    kernel_takes refuses a call, the ones whose wrapper routes it plain
    (the reference's gate fails) are exactly the ones ROUTES says run plain
    on the card, and the rest exactly the ones it says raise there; every
    call a kernel takes hands it a layout its CUDA path takes."""
    called, raises, plain = set(), set(), set()

    def recorder(attr):
        kernel, takes, laid_out, runs_plain = WRAPPER_TAKES[attr]
        wrapper = getattr(tagg, attr)

        def call(*a):
            called.add(kernel)
            if takes(*a):
                assert laid_out(*a), f"{attr} handed a layout its kernel refuses at {name}"
            else:
                (plain if runs_plain(*a) else raises).add(kernel)
            return wrapper(*a)
        return call

    for attr in WRAPPER_TAKES:
        monkeypatch.setattr(tagg, attr, recorder(attr))
    cfg, agg, (img, txt, guid) = selfcheck.route_aggregator(name, T=3)
    with torch.no_grad():
        out = tagg.aggregator_forward(agg, img, txt, guid, cfg)
    assert out.shape == (1, 3, 4 * img.shape[1], 4 * img.shape[2]) and torch.isfinite(out).all()
    assert (called, raises, plain) == selfcheck.ROUTES[name][-3:], (called, raises, plain)


def test_checked_calls_hold_each_call_against_its_plain_version(monkeypatch):
    """selfcheck.checked_calls (chip_smoke [46]-[48]) sees the wrapper calls
    that recorded_calls records on the unfused routes, with the first
    call's input shape and the last-axis widths, and holds each output
    against the plain version as the call is made: 0 on the CPU, where each
    wrapper is its plain version, and the offset of a plain version made
    to differ."""
    cfg, agg, (img, txt, guid) = selfcheck.route_aggregator("hidden32 win4", T=3)
    with torch.no_grad():
        with selfcheck.recorded_calls() as calls:
            want = tagg.aggregator_forward(agg, img, txt, guid, cfg)
        with selfcheck.checked_calls() as checked:
            got = tagg.aggregator_forward(agg, img, txt, guid, cfg)
        assert torch.equal(got, want)
        expect = {}
        for name, (x, *_) in calls:
            n, _, _, first, widths = expect.get((name, x.dtype), (0, 0.0, 0.0, tuple(x.shape), ()))
            expect[(name, x.dtype)] = (n + 1, 0.0, 0.0, first, tuple(sorted({*widths, x.shape[-1]})))
        assert checked == expect
        wrapper, plain = selfcheck.FORWARD_PAIRS["mlp"]
        monkeypatch.setitem(selfcheck.FORWARD_PAIRS, "mlp", (wrapper, lambda *a: plain(*a) + 0.25))
        with selfcheck.checked_calls() as checked:
            tagg.aggregator_forward(agg, img, txt, guid, cfg)
    assert abs(checked[("mlp", torch.float32)][1] - 0.25) < 1e-6
    assert {k: v[1] for k, v in checked.items() if k[0] != "mlp"} == {k: 0.0 for k in expect if k[0] != "mlp"}


# (C, H, Co, M) -> the MLP's decision: the port's kernel takes C % 16 up to
# 512, H % 128 and Co in (32, 64, 128, 256, 384, 512); the reference's gate C
# % 128, H % 128, M >= 1024 rows, C * H <= 2^20
MLP_ROUTES = [
    ((128, 512, 128, 10), "kernel"), ((32, 128, 32, 4608), "kernel"), ((256, 1024, 256, 1024), "kernel"),
    ((192, 768, 192, 4608), "plain"), ((96, 384, 96, 4608), "plain"), ((128, 512, 96, 1023), "plain"),
    ((128, 512, 96, 1024), "raise"), ((512, 2048, 512, 1023), "kernel"), ((512, 2048, 512, 1024), "kernel"),
    ((512, 4096, 512, 4608), "kernel"), ((384, 1536, 384, 4608), "kernel"), ((256, 1000, 256, 4608), "plain"),
    ((640, 1536, 640, 1024), "raise"),
]
# (C, heads, S) -> linear attention's: the port's kernel takes head dims 8-128
# at C <= 128 or C % 128, and every head dim at C % 128 up to 512; the
# reference's gate C % 128, S % 8
LINEAR_ROUTES = [
    ((128, 4, 8), "kernel"), ((128, 4, 13), "kernel"), ((256, 4, 8), "kernel"), ((96, 3, 8), "kernel"),
    ((128, 1, 8), "kernel"), ((128, 1, 13), "kernel"), ((512, 4, 256), "kernel"), ((512, 4, 150), "kernel"),
    ((192, 3, 8), "plain"), ((96, 4, 8), "plain"), ((8, 1, 16), "plain"), ((384, 3, 16), "kernel"),
    ((256, 1, 16), "kernel"), ((256, 1, 13), "kernel"), ((384, 4, 16), "kernel"), ((384, 16, 8), "kernel"),
    ((512, 1, 16), "kernel"), ((384, 128, 16), "kernel"), ((1024, 1, 16), "raise"), ((1024, 1, 13), "plain"),
]


@pytest.mark.parametrize("geometry,want", MLP_ROUTES + LINEAR_ROUTES,
                         ids=[f"mlp{g}" for g, _ in MLP_ROUTES] + [f"linear{g}" for g, _ in LINEAR_ROUTES])
def test_kernel_plain_or_raise_by_geometry(geometry, want):
    """#11 and #12 decide a CUDA call by geometry alone: "kernel" where the
    port's kernel takes it, "plain" where it does not and the reference's
    Pallas gate fails (the reference runs its ``_reference`` there), "raise"
    where it does not and that gate holds.  The gates are read off
    catseg_tpu's wrappers: the MLP's at a geometry the table marks plain or
    raise sends catseg_tpu's call to its reference exactly where the table
    says plain."""
    mod = tmlp if len(geometry) == 4 else tla
    assert mod.route(*geometry) == want
    takes = tmlp.kernel_takes(*geometry[:3]) if mod is tmlp else tla.kernel_takes(*geometry[:2])
    gate = tmlp.reference_gate(geometry[0], geometry[1], geometry[3]) if mod is tmlp else \
        tla.reference_gate(geometry[0], geometry[2])
    assert want == ("kernel" if takes else "raise" if gate else "plain")
    if want == "kernel":
        return
    # catseg_tpu's own wrapper runs its Pallas kernel where the gate holds
    # and its _reference where it fails: trace it with the kernel's entry
    # replaced by a recorder returning zeros of the output's shape
    traced = []
    jmod = jmlp if mod is tmlp else jla
    real = jmod._pallas
    out_shape = (lambda x, w1, b1, w2, *_: (x.shape[0], w2.shape[1])) if mod is tmlp else (lambda q, *_: q.shape)
    try:
        jmod._pallas = lambda *a, **k: (traced.append(1), jnp.zeros(out_shape(*a), a[0].dtype))[1]
        if mod is tmlp:
            C, H, Co, M = geometry
            jax.eval_shape(lambda x, w1, b1, w2, b2: jmlp.fused_mlp(x, w1, b1, w2, b2, "gelu"),
                           *(jax.ShapeDtypeStruct(s, jnp.float32) for s in ((M, C), (C, H), (H,), (H, Co), (Co,))))
        else:
            C, heads, S = geometry
            sd = jax.ShapeDtypeStruct((2, S, C), jnp.float32)
            jax.eval_shape(lambda q, k, v: jla.fused_linear_attention(q, k, v, heads), sd, sd, sd)
    finally:
        jmod._pallas = real
    assert bool(traced) == (want == "raise"), (geometry, traced)


# (C, M, dtype) -> the LayerNorm's decision: the port's kernel takes rows of a
# multiple of 8 up to 4096 bf16, 4 up to 2048 fp32; the reference's gate C %
# 128 and M >= 512 rows
LN_ROUTES = [
    ((768, 5770, "bfloat16"), "kernel"), ((100, 576, "float32"), "kernel"), ((96, 1, "float32"), "kernel"),
    ((2176, 512, "bfloat16"), "kernel"), ((100, 576, "bfloat16"), "plain"), ((6, 64, "bfloat16"), "plain"),
    ((130, 600, "bfloat16"), "plain"), ((4224, 511, "bfloat16"), "plain"), ((2560, 4, "float32"), "plain"),
    ((4224, 512, "bfloat16"), "raise"), ((2176, 512, "float32"), "raise"),
]


@pytest.mark.parametrize("geometry,want", LN_ROUTES, ids=["x".join(map(str, g)) for g, _ in LN_ROUTES])
def test_layer_norm_kernel_plain_or_raise_by_geometry(geometry, want):
    """The LayerNorm decides a CUDA call by geometry alone, as #11 and #12
    do: "kernel" where the port's kernel takes the width, "plain" where it
    does not and the reference's Pallas gate fails, "raise" where that gate
    holds; the gate is read off catseg_tpu's own wrapper, traced with its
    kernel's entry replaced by a recorder."""
    C, M, dt = geometry
    tdt = DTYPES[dt][1]
    assert tln.route(C, M, tdt) == want
    assert want == ("kernel" if tln.kernel_takes(C, tdt) else "raise" if tln.reference_gate(C, M) else "plain")
    traced = []
    real = jln._pallas_ln
    try:
        jln._pallas_ln = lambda x2d, *a, **k: (traced.append(1), jnp.zeros(x2d.shape, x2d.dtype))[1]
        jax.eval_shape(lambda x, g, b: jln.fused_layer_norm(x, g, b), jax.ShapeDtypeStruct((M, C), DTYPES[dt][0]),
                       jax.ShapeDtypeStruct((C,), jnp.float32), jax.ShapeDtypeStruct((C,), jnp.float32))
    finally:
        jln._pallas_ln = real
    assert bool(traced) == tln.reference_gate(C, M), (geometry, traced)


def test_layer_norm_runs_plain_outside_the_kernel_and_the_gate():
    """At a geometry routed "plain" (bf16 rows of 100, the hidden-100
    aggregator's) the plain version matches catseg_tpu's LayerNorm, which
    runs its own plain composition there."""
    rng = np.random.RandomState(7)
    x, g, b = (rng.randn(*s).astype(np.float32) for s in ((576, 100), (100,), (100,)))
    jx, tx = _pair(x, "bfloat16")
    assert tln.route(100, 576, torch.bfloat16) == "plain"
    got = tln.fused_layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    _check(got, jln.fused_layer_norm(jx, jnp.asarray(g), jnp.asarray(b)), "bfloat16")


@pytest.mark.parametrize("kw", [dict(hidden_dim=256), dict(num_heads=1), dict(hidden_dim=192, num_heads=3),
                                dict(hidden_dim=512), dict(hidden_dim=384, num_heads=3), dict(hidden_dim=384),
                                dict(hidden_dim=256, num_heads=1), dict(hidden_dim=96), dict(hidden_dim=100),
                                dict(window_size=24)],
                         ids=["hidden256", "heads1", "hidden192-heads3", "hidden512", "hidden384-heads3",
                              "hidden384", "hidden256-heads1", "hidden96", "hidden100", "window24"])
def test_mini_aggregator_outside_kernel_limits_matches_jax(kw):
    """The mini vitb384 at hidden 256 (Swin and class layer outside the
    port's fused kernels; corr embed, window attention, MLP and linear
    attention take it), at one head of 128 (Swin and class layer outside
    the fused kernels, which take 4 heads; window and linear attention
    take head dim 128), at hidden 192 with 3 heads of 64 (window
    attention takes it; the MLP and linear attention run plain, as the
    reference's gates send them to its plain composition; the corr embed
    and the decoder are outside the reference's gates), and at hidden 512
    (4 heads of 128) and 384 (3 heads of 128), where the corr embed, window
    and linear attention and the MLP (C -> 4C -> C, the reference's Pallas
    MLP in interpret mode) all take it; at hidden 384 with 4 heads of 96
    and hidden 256 with one head of 256 (window and linear attention at
    those head dims, the reference's linear attention on Pallas), at hidden
    96 (4 heads of 24; the MLP and linear attention plain) and at hidden
    100 (4 heads of 25, rows of 100 elements: window attention takes it,
    the LayerNorm's bf16 rows would run plain), and at window 24 (one
    window of 576 tokens, past the window-attention kernel's 256: the card
    raises there), against catseg_tpu's aggregator."""
    cfg, tcfg = mini_cfg(**kw), mini_cfg_port(**kw)
    agg = init_catseg_(CATSeg(tcfg), 0).agg
    params = convert_aggregator_state_dict({k: t.numpy() for k, t in agg.state_dict().items()},
                                           num_layers=tcfg.num_layers)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 24, 24, 64).astype(np.float32)
    txt = rng.randn(1, 3, 1, 64).astype(np.float32)
    guid = (rng.randn(1, 24, 24, 64).astype(np.float32), rng.randn(1, 48, 48, 256).astype(np.float32),
            rng.randn(1, 96, 96, 128).astype(np.float32))
    want = jagg.aggregator_forward(params, jnp.asarray(img), jnp.asarray(txt), tuple(map(jnp.asarray, guid)), cfg)
    with torch.no_grad():
        got = tagg.aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                      tuple(map(torch.from_numpy, guid)), tcfg)
    assert got.shape == (1, 3, 96, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
