"""Deploying the port: its indexer image (``Dockerfile_torch``), the
kustomize overlay ``deploy/torch`` and the rendered H100 fleet's indexer.

No machine these tests run on has docker, kind, helm or a network, so
the image is read, not built, and the overlay's image mapping is applied
here by hand to ``deploy/``'s manifests.  The fleet case renders
``deploy/chart_torch`` in central-socket mode (``indexer.discovery=false``)
and runs its indexer container's ``command`` with its ``env`` as a
process on the loopback (free ports in place of the chart's, the model
pointed at a tokenizer saved in the test's directory); a pod's
``BlockStored`` events, published on the rendered topic with ``POD_IP``
filled in, must make it score the pod.  The same is done with
``deploy/chart`` and the JAX package's service, and the two score maps
must be equal.
"""

import copy
import json
import os
import pathlib
import re
import shlex
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import yaml

from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import publisher as ref_publisher
from tests.helpers.tiny_tokenizer import save_tokenizer_json
from tests.helpers.torch_port import PACKAGE, port
from tests.helpers.charts import (
    REF_CHART,
    by_kind,
    container,
    env_map,
    extract_kv_events,
    render,
    vllm_args,
)
from tests.helpers.charts import CHART as TORCH_CHART

REPO = pathlib.Path(__file__).resolve().parent.parent
DOCKERFILE = REPO / "Dockerfile_torch"
OVERLAY = REPO / "deploy" / "torch" / "kustomization.yaml"
SERVICE_DEPS = ("numpy", "msgpack", "pyzmq", "grpcio", "protobuf", "prometheus-client",
                "transformers", "tokenizers", "xxhash")


# ------------------------------------------------------------ Dockerfile


def instructions(path=DOCKERFILE):
    """(instruction, arguments) of each line of a Dockerfile, comments
    dropped and continuations joined."""
    text = re.sub(r"\\\n", " ", path.read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def pip_installed(args: str) -> list:
    """The requirements of every ``pip install`` in a RUN's command."""
    out = []
    for command in args.split("&&"):
        words = shlex.split(command)
        if words[:2] == ["pip", "install"]:
            out += [w for w in words[2:] if not w.startswith("-")]
    return out


def test_dockerfile_copies_and_installs_nothing_of_the_jax_package():
    steps = instructions()
    copied = [shlex.split(args)[:-1] for op, args in steps if op == "COPY"]
    assert copied == [["pyproject.toml", "README.md"], [PACKAGE]]
    runs = " && ".join(args for op, args in steps if op == "RUN")
    installed = pip_installed(runs)
    assert installed[0] == "." and "--no-deps" in runs
    assert sorted(installed[1:]) == sorted(SERVICE_DEPS)
    for name in installed:
        base = re.split(r"[\[<>=]", name)[0].lower()
        assert base not in ("jax", "jaxlib", "torch", "llm-d-kv-cache-manager-tpu"), name
    assert f"python -m {PACKAGE}.native.build" in runs
    assert "llm_d_kv_cache_manager_tpu." not in runs
    for op, args in steps:
        assert not re.search(r"\bjax\b", args), (op, args)


def test_dockerfile_runs_the_ports_service_at_the_fleets_settings():
    steps = instructions()
    assert ("FROM", "python:3.12-slim AS base") in steps
    runs = " && ".join(args for op, args in steps if op == "RUN")
    assert "libzmq3-dev" in runs and "g++" in runs
    entrypoint = [json.loads(args) for op, args in steps if op == "ENTRYPOINT"]
    assert entrypoint == [["python", "-m", f"{PACKAGE}.api.http_service"]]
    env = dict(args.split("=", 1) for op, args in steps if op == "ENV")
    values = yaml.safe_load((REPO / "deploy" / "chart_torch" / "values.yaml").read_text())
    assert env["PYTHONHASHSEED"] == values["hashSeed"]
    exposed = [int(p) for op, args in steps if op == "EXPOSE" for p in args.split()]
    assert exposed == [values["indexer"]["httpPort"], values["events"]["port"]]


def test_the_images_service_needs_neither_jax_nor_torch():
    """What the image runs imports without ``jax`` and ``torch``: the
    service module and the native build, in an interpreter where both are
    blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'torch', 'llm_d_kv_cache_manager_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"import {PACKAGE}.api.http_service as service\n"
        f"import {PACKAGE}.native.build\n"
        "assert callable(service.main)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


# --------------------------------------------------------------- overlay


def apply_images(docs, images):
    """kustomize's ``images`` transformer on ``docs``: a container image
    whose name matches an entry's ``name`` takes its ``newName`` (and
    ``newTag`` where given), keeping its own tag otherwise."""
    for doc in docs:
        if doc["kind"] != "Deployment":
            continue
        for c in doc["spec"]["template"]["spec"]["containers"]:
            name, _, tag = c["image"].partition(":")
            for entry in images:
                if entry["name"] == name:
                    c["image"] = f"{entry.get('newName', name)}:{entry.get('newTag', tag)}"
    return docs


def base_documents(folder: pathlib.Path):
    kustomization = yaml.safe_load((folder / "kustomization.yaml").read_text())
    docs = []
    for resource in kustomization["resources"]:
        docs += [d for d in yaml.safe_load_all((folder / resource).read_text()) if d]
    return docs


def test_overlay_runs_deploy_indexer_on_the_ports_image():
    overlay = yaml.safe_load(OVERLAY.read_text())
    assert overlay["resources"] == [".."]
    assert overlay["images"] == [{"name": "kv-cache-indexer",
                                  "newName": "kv-cache-indexer-torch"}]
    base = base_documents(OVERLAY.parent / "..")
    mapped = apply_images(copy.deepcopy(base), overlay["images"])
    changed = [(d["kind"], d["metadata"]["name"]) for d, b in zip(mapped, base) if d != b]
    assert changed == [("Deployment", "kv-cache-indexer")]
    indexer = container(mapped[[d["kind"] for d in base].index("Deployment")], "indexer")
    assert indexer["image"] == "kv-cache-indexer-torch:latest"
    # No command in the manifest: the image's entrypoint, the port's
    # service, is what runs.
    assert "command" not in indexer and "args" not in indexer


def test_overlay_image_is_the_one_make_image_torch_builds():
    makefile = (REPO / "Makefile").read_text()
    assert ("docker build -f Dockerfile_torch -t kv-cache-indexer-torch ." in makefile)
    overlay = yaml.safe_load(OVERLAY.read_text())
    assert overlay["images"][0]["newName"] == "kv-cache-indexer-torch"


# --------------------------------------------------------- rendered fleet

MODEL = "test-model"
POD_IP = "10.0.0.7"
SENTENCE = "the quick brown fox jumps over the lazy dog . "


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rendered_indexer(chart):
    """The indexer container's command and env and the vLLM pods'
    ``--kv-events-config`` of ``chart`` rendered in central-socket mode,
    the model set to the test's tokenizer."""
    docs = render(chart, **{"indexer.discovery": "false", "vllm.model.name": MODEL})
    indexer = container(by_kind(docs, "Deployment", component="indexer")[0], "indexer")
    return indexer["command"], env_map(indexer), extract_kv_events(vllm_args(docs))


def scores_from_the_rendered_indexer(chart, events_mod, publisher_mod, tmp_path):
    """Run ``chart``'s rendered indexer on the loopback, publish a pod's
    ``BlockStored`` events on the rendered topic through ``publisher_mod``
    and return the score map once the pod scores."""
    command, rendered_env, kv_events = rendered_indexer(chart)
    assert command[0] == "python"
    http_port, zmq_port = free_port(), free_port()
    assert rendered_env["ZMQ_ENDPOINT"] == f"tcp://*:{kv_events['endpoint'].rsplit(':', 1)[1]}"
    tokenizers_dir = save_tokenizer_json(str(tmp_path), MODEL)
    env = dict(os.environ, **rendered_env)
    env.update(PYTHONPATH=str(REPO), HTTP_PORT=str(http_port),
               ZMQ_ENDPOINT=f"tcp://127.0.0.1:{zmq_port}", LOCAL_TOKENIZER_DIR=tokenizers_dir,
               INCIDENT_DIR=str(tmp_path / "incidents"), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    assert env["PYTHONHASHSEED"] == "42" and env["MODEL_NAME"] == MODEL
    topic = kv_events["topic"].replace("${POD_IP}", POD_IP)
    block = int(rendered_env["BLOCK_SIZE"])
    tokens = port("tokenization.tokenizers").LocalFastTokenizer(tokenizers_dir).encode(
        SENTENCE * 8, MODEL, False).tokens
    n_blocks = len(tokens) // block
    assert n_blocks >= 4
    batch = [events_mod.BlockStored(
        block_hashes=[0x7000 + i for i in range(n_blocks)], parent_block_hash=None,
        token_ids=tokens[: n_blocks * block], block_size=block, medium="gpu")]
    log = open(tmp_path / "service.log", "wb")
    service = subprocess.Popen([sys.executable] + command[1:], env=env, cwd=str(tmp_path),
                               stdout=log, stderr=subprocess.STDOUT)
    publisher = None
    try:
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 90
        while True:
            assert service.poll() is None, (tmp_path / "service.log").read_text()[-3000:]
            assert time.monotonic() < deadline, "the service never answered /healthz"
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as response:
                    if json.load(response)["status"] == "ok":
                        break
            except OSError:
                time.sleep(0.2)
        publisher = publisher_mod.Publisher(f"tcp://127.0.0.1:{zmq_port}", POD_IP, MODEL,
                                            bind=False)
        assert publisher.topic == topic
        request = json.dumps({"prompt": SENTENCE * 8, "model": MODEL}).encode()
        scores = {}
        while not scores:
            assert time.monotonic() < deadline, "the pod's events never reached the index"
            publisher.publish(*batch)
            time.sleep(0.2)
            post = urllib.request.Request(base + "/score_completions", data=request,
                                          headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(post, timeout=10) as response:
                scores = json.load(response)
        return scores, n_blocks
    finally:
        if publisher is not None:
            publisher.close()
        service.terminate()
        try:
            service.wait(timeout=30)
        except subprocess.TimeoutExpired:
            service.kill()
            service.wait(timeout=30)
        log.close()


def test_rendered_fleet_scores_a_pod_as_the_reference_chart_does(tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    command, _, _ = rendered_indexer(TORCH_CHART)
    assert command == ["python", "-m", f"{PACKAGE}.api.http_service"]
    got, n_blocks = scores_from_the_rendered_indexer(
        TORCH_CHART, port("kvevents.events"), port("kvevents.publisher"), port_dir)
    want, _ = scores_from_the_rendered_indexer(REF_CHART, ref_events, ref_publisher, ref_dir)
    assert got == want == {POD_IP: float(n_blocks)}


@pytest.mark.parametrize("chart", [TORCH_CHART, REF_CHART], ids=["torch", "reference"])
def test_rendered_central_mode_wires_the_pods_to_the_indexer(chart):
    """What the fleet case relies on, per chart: vLLM's publisher connects
    to the indexer Service's port the indexer binds, on a topic under the
    indexer's prefix that names the pod by ``POD_IP`` and the model."""
    command, env, kv_events = rendered_indexer(chart)
    assert kv_events["endpoint"].rsplit(":", 1)[1] == env["ZMQ_ENDPOINT"].rsplit(":", 1)[1]
    assert kv_events["topic"] == f"{env['ZMQ_TOPIC']}${{POD_IP}}@{env['MODEL_NAME']}"
    assert "POD_DISCOVERY" not in env
