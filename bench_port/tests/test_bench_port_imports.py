"""What ``python -m bench_port.run`` loads: never JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and a reference that imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "llm_d_kv_cache_manager_tpu"}
PORT = "llm_d_kv_cache_manager_tpu_torch"

# Import run.py and every module a run reaches, the port's included.
PROBE = """
import json, sys
import bench_port.run as run
from bench_port import spec, serve, check, mfu, trace
from bench_port.reference import model, router
for name in ("models.llama", "models.kv_cache_pool", "kvcache.indexer", "kvevents.pool",
             "kvevents.events", "kvevents.zmq_subscriber", "metrics.collector",
             "kvcache.kvblock.token_processor", "tokenization.tokenizers"):
    serve.port(name)
for kind in ("open", "closed"):
    spec.traffic_kind(kind)
bench = json.load(open("BENCHMARK.json"))
for c in bench["configs"]:
    spec.family_of(json.load(open(c["file"])))
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_the_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in top and "bench_port" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "bench_port" / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {PORT}, (path.name, name)
            assert top != "bench_port", (path.name, name)  # nothing of the harness either
    # And loaded alone, it pulls in nothing of the port.
    probe = ("import sys, bench_port.reference.model, bench_port.reference.router; "
             f"print(any(m.split('.')[0] == {PORT!r} for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False"
