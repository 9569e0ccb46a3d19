"""Everything BENCHMARK.json names is found by name, as the contract
holds it."""
import json
import re

import pytest

from benchmark.lib import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["bound"] <= 0.25 and m["bound"] >= 0.01 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_metrics(cell):
    w = spec.find_cell(BENCH, cell)
    conf = spec.load_config(BENCH, w["config"])
    mix = spec.load_mix(w["traffic"])
    assert conf["reduced"] == [c for c in BENCH["configs"] if c["name"] == w["config"]][0][
        "reduced"]
    assert {"loop", "arrival", "prompt", "output_frames", "sampling", "check"} <= set(mix)
    e2e = spec.cell_metrics(BENCH, cell, False)
    layer = spec.cell_metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    assert {m["moves"] for m in layer} <= {m["name"] for m in e2e}
    for m in e2e + layer:
        assert callable(spec.load_reader(m["name"]).read)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engine (host)", "model step", "kernels", "device"}


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        spec.load_mix("no-such-mix")
    with pytest.raises(KeyError):
        spec.load_reader("no_such_metric.chat")
    with pytest.raises(KeyError, match="families/no-such-family"):
        spec.family({"family": "no-such-family"})


def test_split_metrics_share_their_quantity_reader():
    """``frame_device_ms.chat`` and ``.read`` differ only in the metric they
    move, ``audio_s_per_s.clone`` from ``audio_s_per_s`` only in its bound;
    each reads the file of the part before the dot."""
    split = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k] if "." in m["name"]]
    assert split
    for name in split:
        assert spec.load_reader(name).__file__.endswith(f"/{name.split('.')[0]}.py")


def test_configs_keep_published_widths():
    published = {
        "mistral-7b-v0.3": dict(hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                                rope_theta=1e6, rms_norm_eps=1e-5, tie_word_embeddings=False),
        "smollm2-1.7b": dict(hidden_size=2048, intermediate_size=8192, num_hidden_layers=24,
                             num_attention_heads=32, num_key_value_heads=32, head_dim=64,
                             rope_theta=130000, rms_norm_eps=1e-5, tie_word_embeddings=True),
    }
    for name, keys in published.items():
        conf = spec.load_config(BENCH, name)
        assert {k: conf[k] for k in keys} == keys
        assert conf["reduced"] == ["vocab_size"] and "vocab_size" in conf["assumed"]
