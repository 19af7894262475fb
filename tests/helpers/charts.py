"""Rendering the repo's Helm charts in tests, and reading what they render.

Real helm renders when it is on PATH, the subset renderer
(hack/render_chart.py) otherwise; ``KVTPU_CHART_RENDERER=subset|helm``
forces one, as in tests/test_chart.py.  A ``fail`` in a template raises
``ValueError`` under either.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "hack"))
from render_chart import render_chart  # noqa: E402

DEPLOY = os.path.join(os.path.dirname(__file__), "..", "..", "deploy")
CHART = os.path.join(DEPLOY, "chart_torch")
REF_CHART = os.path.join(DEPLOY, "chart")

_FORCED = os.environ.get("KVTPU_CHART_RENDERER", "")
HELM = shutil.which("helm") if _FORCED != "subset" else None
if _FORCED == "helm" and not HELM:
    raise RuntimeError("KVTPU_CHART_RENDERER=helm but helm not on PATH")


def render_with_helm(chart, **set_values):
    cmd = ["helm", "template", "kvtpu", chart]
    for key, value in set_values.items():
        cmd += ["--set", f"{key}={value}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ValueError(proc.stderr)
    return proc.stdout


def render_text(chart=CHART, **set_values):
    if HELM:
        return render_with_helm(chart, **set_values)
    return render_chart(chart, set_values=set_values or None)


def render(chart=CHART, **set_values):
    return [d for d in yaml.safe_load_all(render_text(chart, **set_values)) if d is not None]


def by_kind(docs, kind, component=None):
    out = []
    for doc in docs:
        if doc["kind"] != kind:
            continue
        labels = doc["metadata"].get("labels", {})
        if component and labels.get("app.kubernetes.io/component") != component:
            continue
        out.append(doc)
    return out


def container(deployment, name):
    for c in deployment["spec"]["template"]["spec"]["containers"]:
        if c["name"] == name:
            return c
    raise AssertionError(f"no container {name!r}")


def env_map(container_spec):
    return {env["name"]: env["value"] for env in container_spec.get("env", [])
            if "value" in env}


def vllm_args(docs):
    dep = by_kind(docs, "Deployment", component="vllm")[0]
    return container(dep, "vllm")["args"][0]


def indexer_env(docs):
    return env_map(container(by_kind(docs, "Deployment", component="indexer")[0], "indexer"))


def kv_transfer_text(args_text: str) -> str:
    match = re.search(r"--kv-transfer-config '([^']+)'", args_text)
    assert match, "no --kv-transfer-config in vllm args"
    return match.group(1)


def extract_kv_transfer(args_text: str) -> dict:
    return json.loads(kv_transfer_text(args_text))


def extract_kv_events(args_text: str) -> dict:
    match = re.search(r'--kv-events-config "((?:[^"\\]|\\.)+)"', args_text)
    assert match, "no --kv-events-config in vllm args"
    return json.loads(match.group(1).replace('\\"', '"'))


def flag_value(args_text: str, flag: str) -> str:
    match = re.search(rf"{flag}\s+(\S+)", args_text)
    assert match, f"no {flag} in vllm args"
    return match.group(1).rstrip("\\").strip()


def gpus(docs) -> int:
    dep = by_kind(docs, "Deployment", component="vllm")[0]
    return int(container(dep, "vllm")["resources"]["requests"]["nvidia.com/gpu"])
