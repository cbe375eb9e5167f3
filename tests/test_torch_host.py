"""The port's own copies of catseg_tpu's host code, on the CPU: config
presets, class lists, the CLIP tokenizer and templates, and the checkpoint
exporter must give exactly what catseg_tpu's give."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax

import catseg_tpu
from catseg_tpu import configs as jconfigs
from catseg_tpu.core.catseg import init_catseg_params
from catseg_tpu.text import templates as jtemplates
from catseg_tpu.text.tokenizer import tokenize as jtokenize
from catseg_tpu.weights.export import export_catseg_checkpoint as j_export

import catseg_tpu_torch
from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.text import templates as ttemplates
from catseg_tpu_torch.text.tokenizer import tokenize as ttokenize
from catseg_tpu_torch.weights.export import export_catseg_checkpoint as t_export

from test_torch_aggregator import mini_cfg

PRESETS = ["vitb384", "vitl336", "vith336", "vitg336", "fusion_ver31", "fusion_ver14"]
BENCHMARKS = sorted(p.stem for p in (Path(catseg_tpu.__file__).parent / "data" / "class_jsons").glob("*.json"))


@pytest.mark.parametrize("eval_", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_jax(preset, eval_):
    j, t = getattr(jconfigs, preset)(), getattr(tconfigs, preset)()
    if eval_:
        j, t = jconfigs.eval_preset(j), tconfigs.eval_preset(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.prompt_channel, t.sw_stride) == (j.prompt_channel, j.sw_stride)


def test_variants_and_pixel_stats_match_jax():
    for name in ("VITB16", "VITL14_336", "VITB32", "VITH14", "VITG14"):
        assert dataclasses.asdict(getattr(tconfigs, name)) == dataclasses.asdict(getattr(jconfigs, name))
    assert tconfigs.CLIP_PIXEL_MEAN == jconfigs.CLIP_PIXEL_MEAN
    assert tconfigs.CLIP_PIXEL_STD == jconfigs.CLIP_PIXEL_STD
    assert dataclasses.asdict(tconfigs.FusionConfig()) == dataclasses.asdict(jconfigs.FusionConfig())


@pytest.mark.parametrize("benchmark", BENCHMARKS)
def test_class_lists_match_jax(benchmark):
    path = Path(catseg_tpu.__file__).parent / "data" / "class_jsons" / f"{benchmark}.json"
    assert tconfigs.class_names(benchmark) == json.loads(path.read_text())


def test_class_lists_ship_with_the_port():
    ours = Path(catseg_tpu_torch.__file__).parent / "data" / "class_jsons"
    assert sorted(p.stem for p in ours.glob("*.json")) == BENCHMARKS


def test_templates_match_jax():
    assert ttemplates.SETS == jtemplates.SETS
    assert ttemplates.format_template("a {article} {category}.", "apple") == \
        jtemplates.format_template("a {article} {category}.", "apple")


def test_token_ids_match_jax_on_ade847():
    names = tconfigs.class_names("ade847")
    assert len(names) == 847
    texts = [ttemplates.format_template(ttemplates.SINGLE[0], n.split(", ")[0]) for n in names] + names
    np.testing.assert_array_equal(ttokenize(texts), jtokenize(texts))


def test_export_matches_jax():
    cfg = mini_cfg()
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_catseg_params(k, cfg))(jax.random.PRNGKey(1)))
    want, got = j_export(params), t_export(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_export_refuses_fusion_pytrees():
    """The exporter takes the fork's fusion pytrees now (their round trips:
    tests/test_torch_fusion.py); an incomplete one raises as catseg_tpu's."""
    with pytest.raises(KeyError) as want:
        j_export({"dino": {}, "agg": {}})
    with pytest.raises(KeyError) as got:
        t_export({"dino": {}, "agg": {}})
    assert str(got.value) == str(want.value)
