"""The model-family seam: a configuration names its family, the family's
file is all the harness knows of a model, and a family's arithmetic is
the harness's, bit for bit."""

import ast
import dataclasses
import json
import re
from pathlib import Path

import pytest

from bench_port import roofline, spec
from bench_port import run as bench_run
from bench_port.tests.test_bench_port_serving import CPU, TINY, correct, tiny_cell

HERE = Path(__file__).resolve().parents[1]
PEAKS = roofline.PEAKS["H100 SXM"]

PREFILLS = [(0, 4096), (4096, 256), (0, 16), (8192, 2048)]
# Decode rows (contexts, distinct pool slots read or None).
DECODES = [((1,), None), ((12288,), None), ((1, 517, 4353, 12288), None),
           ((1, 517, 4353, 12288), 13000), ((4096,) * 24, None),
           ((300, 301, 2050, 7000, 12287, 64), 9000)]

# What the arithmetic gave before it moved into the family
# (``roofline.prefill_model_flops``, ``decode_model_flops`` and
# ``mfu._bound_s``), over PREFILLS and DECODES.
GOLDEN = {
    "mistral-7b-v0.3": {
        "prefill_flops": [61573993332736.0, 4140684017664.0, 223678038016.0, 38483712278528.0],
        "prefill_attention_bound_s": [0.004448048789613752, 0.0005733091930596562,
                                      3.1300776119402986e-06, 0.010006209829015168],
        "decode_flops": [14227603456.0, 20669530112.0, 65904574464.0, 65904574464.0,
                         392989507584.0, 96897859584.0],
        "decode_attention_bound_s": [1.9562985074626866e-07, 0.00048093642507462687,
                                     0.0006719885373134329, 0.0005092636274626866,
                                     0.003849995462686567, 0.00035307275462686567],
    },
    "deepseek-llm-7b-base": {
        "prefill_flops": [53860735385600.0, 3640886558720.0, 195185868800.0, 34146332180480.0],
        "prefill_attention_bound_s": [0.0041700457402628925, 0.0006760967641791045,
                                      4.695116417910448e-06, 0.009380821714701719],
        "decode_flops": [12981862400.0, 19021168640.0, 60359475200.0, 60359475200.0,
                         359871283200.0, 88702648320.0],
        "decode_attention_bound_s": [2.93444776119403e-07, 0.0018030714268656716,
                                     0.0025181963462686564, 0.0019079779343283583,
                                     0.014426918973134329, 0.0013213818268656716],
    },
    "tiny": {
        "prefill_flops": [11008081920.0, 1258553344.0, 9707520.0, 20536492032.0],
        "prefill_attention_bound_s": [8.687595292214359e-06, 1.119744517694641e-06,
                                      7.336119402985074e-09, 1.954337857229525e-05],
        "decode_flops": [721920.0, 13303808.0, 20454400.0, 20454400.0, 117964800.0, 26855424.0],
        "decode_attention_bound_s": [4.5850746268656714e-10, 1.8783522388059701e-06,
                                     2.623732537313433e-06, 1.9880883582089554e-06,
                                     1.5031708656716418e-05, 1.3773564179104477e-06],
    },
}


def _config(name):
    if name == "tiny":
        return TINY
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _costs(shape, function):
    if function == "prefill_flops":
        return [shape.prefill_flops(p, n) for p, n in PREFILLS]
    if function == "prefill_attention_bound_s":
        return [shape.prefill_attention_bound_s(p, n, PEAKS) for p, n in PREFILLS]
    if function == "decode_flops":
        return [shape.decode_flops(c) for c, _ in DECODES]
    return [shape.decode_attention_bound_s(c, k, PEAKS) for c, k in DECODES]


@pytest.mark.parametrize("function", sorted(GOLDEN["tiny"]))
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_a_familys_costs_equal_the_harness_arithmetic(name, function):
    config = _config(name)
    shape = spec.family_of(config).shape(config)
    assert _costs(shape, function) == GOLDEN[name][function]


WRAPPED = '''"""The llama family under another name."""
from bench_port import spec

_llama = spec.family("llama")
shape, weights, reference_logits = _llama.shape, _llama.weights, _llama.reference_logits
built = []


def model(config, mix):
    built.append(config["family"])
    return _llama.model(config, mix)
'''


def test_a_family_from_new_files_only_serves_correctly(tmp_path):
    """A family file and a configuration naming it, in a folder of their
    own, make a cell that serves and comes out correct."""
    folder = tmp_path / "families"
    folder.mkdir()
    (folder / "wrapped.py").write_text(WRAPPED)
    (tmp_path / "wrapped.json").write_text(json.dumps(dict(TINY, family="wrapped")))
    config = json.loads((tmp_path / "wrapped.json").read_text())
    family = spec.family_of(config, "wrapped.json", folder)
    cell = dataclasses.replace(tiny_cell("open"), config=config, family=family)
    run = bench_run.serve_cell(cell, 2**31 + 7, 0.75, False, CPU)
    compared = bench_run.checks(run, CPU)
    assert correct(compared), compared
    assert family.built == ["wrapped"]
    assert bench_run.record(run)["shape"] == family.shape(config)


PORT_MODEL = ("models.llama", "LlamaConfig", "KVCachePool")
LEAVES = {"ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "ln_f"}
SIZES = {"n_layers", "n_kv_heads", "head_dim", "d_model", "d_ff"}


def _named(path: Path):
    """Every identifier and every word of every string in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value
        elif isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, ast.alias):
            yield node.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.arg):
            yield node.arg


def test_only_a_family_file_names_the_ports_model():
    harness = [p for p in sorted(HERE.rglob("*.py"))
               if p.relative_to(HERE).parts[0] not in ("families", "tests")]
    assert HERE / "serve.py" in harness and HERE / "reference" / "model.py" in harness
    for path in harness:
        for text in _named(path):
            assert not any(n in text for n in PORT_MODEL), (path.name, text)


@pytest.mark.parametrize("module", ["serve", "run", "check", "mfu", "roofline", "weights"])
def test_the_loop_and_the_arithmetic_name_no_leaf_and_no_size(module):
    """No Llama leaf, and, outside the primitives of ``roofline.py``, no
    size of a block: the pool's layout and a block's bytes are the
    family's."""
    words = {w for text in _named(HERE / f"{module}.py") for w in re.findall(r"\w+", text)}
    assert not words & LEAVES, words & LEAVES
    if module != "roofline":
        assert not words & SIZES, words & SIZES


def _bench(tmp_path, config) -> Path:
    (tmp_path / "x.json").write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "c", "config": "x", "traffic": "shared-prefix", "chips": 1}],
        "configs": [{"name": "x", "file": "x.json"}], "end_to_end": [], "per_layer": []}))
    return tmp_path / "BENCHMARK.json"


@pytest.mark.parametrize("family", [None, "mamba"])
def test_a_configuration_without_a_known_family_is_refused(tmp_path, family):
    config = {k: v for k, v in TINY.items() if k != "family"}
    if family is not None:
        config["family"] = family
    with pytest.raises(ValueError, match=r'x\.json must name its model family under the key '
                                         r'"family" .*families found: (.*, )?llama\b'):
        spec.load_cell(_bench(tmp_path, config), "c")


def test_a_configuration_naming_its_family_loads_it(tmp_path):
    cell = spec.load_cell(_bench(tmp_path, TINY), "c")
    assert cell.family.shape(cell.config).n_layers == TINY["num_hidden_layers"]
