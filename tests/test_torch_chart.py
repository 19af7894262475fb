"""The H100 serving-fleet chart (``deploy/chart_torch``): every case of
tests/test_chart.py on it, its nodepool, its parity with ``deploy/chart``
and the connector config ``chip_smoke.py`` phase 7e runs on the card.

The chart is ``deploy/chart`` with only what the accelerator and the
package decide changed.  The parity cases render both charts with the
defaults and with each variant of ``TestVariants``, map the differences
stated in ``to_reference`` (and nothing else) from this chart's
documents to the reference chart's values, and require every document
to be equal.  Rendering goes through real helm when it is on PATH, the
subset renderer (hack/render_chart.py) otherwise, as tests/test_chart.py
does.
"""

import copy
import json
import os
import runpy

import pytest
import yaml

from tests.helpers.charts import (
    CHART,
    HELM,
    REF_CHART,
    by_kind,
    container,
    env_map,
    extract_kv_events,
    extract_kv_transfer,
    flag_value,
    gpus,
    indexer_env,
    kv_transfer_text,
    render,
    render_chart,
    render_text,
    render_with_helm,
    vllm_args,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
PORT_SPEC = "llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec"
REF_SPEC = "llm_d_kv_cache_manager_tpu.offload.vllm_spec"
PORT_SERVICE = "llm_d_kv_cache_manager_tpu_torch.api.http_service"
REF_SERVICE = "llm_d_kv_cache_manager_tpu.api.http_service"


class TestDefaultRender:
    def test_all_documents_parse_with_kind_and_name(self):
        docs = render()
        assert len(docs) >= 7
        for doc in docs:
            assert doc["kind"]
            assert doc["metadata"]["name"]

    def test_expected_components_present(self):
        docs = render()
        kinds = {(d["kind"], d["metadata"]["name"]) for d in docs}
        names = {name for _, name in kinds}
        assert any("vllm" in n for n in names)
        assert any("indexer" in n for n in names)
        assert ("PersistentVolumeClaim", "kvtpu-shared-kv") in kinds
        assert any(k == "Role" for k, _ in kinds)

    def test_h100_nodepool_no_tpu(self):
        """The counterpart of test_chart.py's TPU nodepool case: one H100
        80GB card a pod, requested and limited, tolerated; nothing of a
        TPU anywhere in the render; tp within the pod's cards."""
        text = render_text()
        docs = [d for d in yaml.safe_load_all(text) if d is not None]
        dep = by_kind(docs, "Deployment", component="vllm")[0]
        pod = dep["spec"]["template"]["spec"]
        assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        resources = container(dep, "vllm")["resources"]
        assert resources["requests"]["nvidia.com/gpu"] == "1"
        assert resources["limits"]["nvidia.com/gpu"] == "1"
        assert {"key": "nvidia.com/gpu", "operator": "Exists",
                "effect": "NoSchedule"} in pod["tolerations"]
        assert container(dep, "vllm")["image"] == "vllm/vllm-openai:latest"
        assert "google.com/tpu" not in text and "gke-tpu" not in text
        assert int(flag_value(vllm_args(docs), "--tensor-parallel-size")) <= gpus(docs)

    def test_the_port_runs_everywhere(self):
        """The connector vLLM loads and the indexer's service are the
        port's, and its image is the port's."""
        docs = render()
        extra = extract_kv_transfer(vllm_args(docs))["kv_connector_extra_config"]
        assert extra["spec_module_path"] == PORT_SPEC
        idx = container(by_kind(docs, "Deployment", component="indexer")[0], "indexer")
        assert idx["command"] == ["python", "-m", PORT_SERVICE]
        assert idx["image"] == "ghcr.io/llm-d/kv-cache-indexer-torch:latest"


class TestCrossInvariants:
    """A mismatch in any of these silently zeroes the cache-hit rate."""

    def test_hash_seed_agrees(self):
        docs = render()
        vllm_env = env_map(container(by_kind(docs, "Deployment", component="vllm")[0], "vllm"))
        assert vllm_env["PYTHONHASHSEED"] == indexer_env(docs)["PYTHONHASHSEED"] == "42"

    def test_block_size_agrees(self):
        docs = render()
        assert flag_value(vllm_args(docs), "--block-size") == indexer_env(docs)["BLOCK_SIZE"]

    def test_offload_block_size_multiple_of_device(self):
        args = vllm_args(render())
        extra = extract_kv_transfer(args)["kv_connector_extra_config"]
        device_bs = int(flag_value(args, "--block-size"))
        assert extra["block_size"] % device_bs == 0
        assert extra["spec_name"] == "TPUSharedStorageOffloadingSpec"
        assert extra["spec_module_path"] == PORT_SPEC

    def test_spec_name_is_a_class_of_the_named_module(self):
        """vLLM's OffloadingConnector imports ``spec_module_path`` and
        looks ``spec_name`` up on it; both resolve in the port, to the
        spec that reads ``threads_per_chip``."""
        import importlib

        extra = extract_kv_transfer(vllm_args(render()))["kv_connector_extra_config"]
        cls = getattr(importlib.import_module(extra["spec_module_path"]), extra["spec_name"])
        assert cls.__module__ == PORT_SPEC
        assert extra["threads_per_chip"] == 8 and extra["max_staging_memory_gb"] == 16

    def test_engine_hash_algo_is_cbor_interop(self):
        assert "--prefix-caching-hash-algo sha256_cbor" in vllm_args(render())

    def test_zmq_port_and_topic_agree(self):
        docs = render()
        events = extract_kv_events(vllm_args(docs))
        idx_env = indexer_env(docs)
        assert events["enable_kv_cache_events"] is True
        assert events["publisher"] == "zmq"
        port = int(events["endpoint"].rsplit(":", 1)[1])
        assert port == int(idx_env["POD_SOCKET_PORT"])
        assert events["topic"].startswith(idx_env["ZMQ_TOPIC"])

    def test_discovery_label_matches_selector(self):
        docs = render()
        vllm_labels = by_kind(docs, "Deployment", component="vllm")[0][
            "spec"]["template"]["metadata"]["labels"]
        key, _, value = indexer_env(docs)["POD_LABEL_SELECTOR"].partition("=")
        assert vllm_labels.get(key) == value

    def test_shared_storage_path_is_mounted(self):
        docs = render()
        dep = by_kind(docs, "Deployment", component="vllm")[0]
        extra = extract_kv_transfer(vllm_args(docs))["kv_connector_extra_config"]
        mounts = {m["name"]: m["mountPath"] for m in container(dep, "vllm")["volumeMounts"]}
        assert extra["shared_storage_path"].startswith(mounts["shared-kv"])
        volumes = {v["name"]: v for v in dep["spec"]["template"]["spec"]["volumes"]}
        claim = volumes["shared-kv"]["persistentVolumeClaim"]["claimName"]
        pvc = by_kind(docs, "PersistentVolumeClaim")[0]
        assert pvc["metadata"]["name"] == claim
        assert pvc["spec"]["accessModes"] == ["ReadWriteMany"]

    def test_model_name_agrees(self):
        docs = render()
        served = vllm_args(docs).split("vllm serve ", 1)[1].split()[0]
        assert indexer_env(docs)["MODEL_NAME"] == served

    def test_tensor_parallel_within_pod_gpus(self):
        docs = render()
        assert int(flag_value(vllm_args(docs), "--tensor-parallel-size")) <= gpus(docs)


class TestVariants:
    def test_central_socket_mode(self):
        docs = render(**{"indexer.discovery": "false"})
        assert not by_kind(docs, "Role")
        idx_env = indexer_env(docs)
        assert "POD_DISCOVERY" not in idx_env
        assert idx_env["ZMQ_ENDPOINT"].startswith("tcp://*:")
        bind_port = int(idx_env["ZMQ_ENDPOINT"].rsplit(":", 1)[1])
        events = extract_kv_events(vllm_args(docs))
        assert "kv-cache-indexer" in events["endpoint"]
        assert int(events["endpoint"].rsplit(":", 1)[1]) == bind_port
        svc = by_kind(docs, "Service", component="indexer")[0]
        ports = {p["name"]: p["port"] for p in svc["spec"]["ports"]}
        assert ports["zmq"] == bind_port

    def test_valkey_mode_wires_index_backend(self):
        docs = render(**{"valkey.enabled": "true"})
        valkey_svc = by_kind(docs, "Service", component="valkey")[0]
        backend = indexer_env(docs)["INDEX_BACKEND"]
        assert backend.startswith("valkey://")
        assert valkey_svc["metadata"]["name"] in backend
        assert backend.endswith(f":{valkey_svc['spec']['ports'][0]['port']}")

    def test_valkey_disabled_omits_backend(self):
        assert "INDEX_BACKEND" not in indexer_env(render())

    def test_seed_override_flows_everywhere(self):
        docs = render(**{"hashSeed": '"7"'})
        vllm_env = env_map(container(by_kind(docs, "Deployment", component="vllm")[0], "vllm"))
        assert vllm_env["PYTHONHASHSEED"] == "7"
        assert indexer_env(docs)["PYTHONHASHSEED"] == "7"

    def test_existing_claim_suppresses_pvc(self):
        docs = render(**{"sharedStorage.existingClaim": "my-filestore"})
        assert not by_kind(docs, "PersistentVolumeClaim")
        dep = by_kind(docs, "Deployment", component="vllm")[0]
        volumes = {v["name"]: v for v in dep["spec"]["template"]["spec"]["volumes"]}
        assert volumes["shared-kv"]["persistentVolumeClaim"]["claimName"] == "my-filestore"

    def test_secret_create_renders_secret(self):
        secrets = by_kind(render(**{"secret.create": "true", "secret.hfTokenValue": "hf_abc"}),
                          "Secret")
        assert len(secrets) == 1
        assert secrets[0]["stringData"]["hf_token"] == "hf_abc"

    def test_offload_disabled_drops_transfer_config(self):
        args = vllm_args(render(**{"vllm.offload.enabled": "false"}))
        assert "--kv-transfer-config" not in args
        assert "--kv-events-config" in args

    def test_offload_without_shared_storage_fails_render(self):
        with pytest.raises(ValueError, match="sharedStorage.enabled"):
            render(**{"sharedStorage.enabled": "false"})

    def test_multi_replica_indexer_without_valkey_fails_render(self):
        with pytest.raises(ValueError, match="valkey.enabled"):
            render(**{"indexer.replicaCount": "2"})

    def test_multi_replica_indexer_with_valkey_renders(self):
        docs = render(**{"indexer.replicaCount": "2", "valkey.enabled": "true"})
        assert by_kind(docs, "Deployment", component="indexer")[0]["spec"]["replicas"] == 2

    def test_namespace_defaults_to_default_like_helm(self):
        assert {d["metadata"]["namespace"] for d in render()} == {"default"}

    def test_shell_command_has_no_dangling_continuation(self):
        for overrides in ({}, {"vllm.offload.enabled": "false"}, {"indexer.discovery": "false"},
                          {"indexer.enabled": "false"}):
            lines = [ln.strip() for ln in vllm_args(render(**overrides)).strip().split("\n")]
            assert not lines[-1].endswith("\\"), overrides
            for line in lines[:-1]:
                assert line.endswith("\\"), (overrides, line)

    def test_more_cards_a_pod_flow_into_requests_and_limits(self):
        docs = render(**{"vllm.gpu.count": "4", "vllm.tensorParallelSize": "4"})
        resources = container(by_kind(docs, "Deployment", component="vllm")[0],
                              "vllm")["resources"]
        assert resources["requests"]["nvidia.com/gpu"] == "4"
        assert resources["limits"]["nvidia.com/gpu"] == "4"
        assert flag_value(vllm_args(docs), "--tensor-parallel-size") == "4"


@pytest.mark.skipif(not HELM, reason="real helm not on PATH")
class TestRendererParity:
    """With real helm present, the subset renderer must give this chart
    the same documents, as for deploy/chart."""

    @pytest.mark.parametrize(
        "overrides",
        [{}, {"valkey.enabled": "true"}, {"indexer.discovery": "false"},
         {"vllm.offload.enabled": "false"}, {"sharedStorage.existingClaim": "my-filestore"}],
        ids=["defaults", "valkey", "central", "no-offload", "byo-pvc"],
    )
    def test_subset_renderer_matches_helm(self, overrides):
        def normalize(text):
            docs = [d for d in yaml.safe_load_all(text) if d is not None]
            return sorted(docs, key=lambda d: (d["kind"], d["metadata"]["name"]))

        helm_docs = normalize(render_with_helm(CHART, **overrides))
        subset_docs = normalize(render_chart(CHART, set_values=overrides or None))
        assert helm_docs == subset_docs


# ---------------------------------------------------------------- parity

# The stated differences, this chart's value -> deploy/chart's.
CHART_NAMES = ("h100-serving-fleet", "tpu-serving-fleet")
NODE_SELECTORS = ({"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
                  {"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
                   "cloud.google.com/gke-tpu-topology": "2x2"})
TOLERATION_KEYS = ("nvidia.com/gpu", "google.com/tpu")
RESOURCES = (("nvidia.com/gpu", "1"), ("google.com/tpu", "4"))
VLLM_IMAGES = ("vllm/vllm-openai:latest", "vllm/vllm-tpu:nightly")
INDEXER_IMAGES = ("ghcr.io/llm-d/kv-cache-indexer-torch:latest",
                  "ghcr.io/llm-d/kv-cache-indexer-tpu:latest")
SPEC_MODULES = (PORT_SPEC, REF_SPEC)
SERVICES = (PORT_SERVICE, REF_SERVICE)
TENSOR_PARALLEL = ("--tensor-parallel-size 1 ", "--tensor-parallel-size 4 ")


def _swap(value, pair):
    assert value == pair[0], (value, pair)
    return pair[1]


def to_reference(doc):
    """This chart's document with each stated difference replaced by
    deploy/chart's value; every replaced field must hold exactly the
    stated value first."""
    doc = copy.deepcopy(doc)
    labelled = [doc["metadata"]]
    if doc["kind"] == "Deployment":
        labelled.append(doc["spec"]["template"]["metadata"])
    for meta in labelled:
        labels = meta.get("labels", {})
        if "app.kubernetes.io/name" in labels:
            labels["app.kubernetes.io/name"] = _swap(labels["app.kubernetes.io/name"],
                                                     CHART_NAMES)
    component = doc["metadata"].get("labels", {}).get("app.kubernetes.io/component")
    if doc["kind"] != "Deployment":
        return doc
    pod = doc["spec"]["template"]["spec"]
    if component == "vllm":
        pod["nodeSelector"] = _swap(pod["nodeSelector"], NODE_SELECTORS)
        for toleration in pod.get("tolerations", []):
            toleration["key"] = _swap(toleration["key"], TOLERATION_KEYS)
        vllm = container(doc, "vllm")
        vllm["image"] = _swap(vllm["image"], VLLM_IMAGES)
        for side in ("requests", "limits"):
            resources = vllm["resources"][side]
            key, value = RESOURCES[0]
            assert resources.pop(key) == value
            resources = {RESOURCES[1][0]: RESOURCES[1][1], **resources}
            vllm["resources"][side] = resources
        args = vllm["args"][0]
        assert args.count(TENSOR_PARALLEL[0]) == 1
        args = args.replace(TENSOR_PARALLEL[0], TENSOR_PARALLEL[1])
        if "--kv-transfer-config" in args:
            assert args.count(SPEC_MODULES[0]) == 1
            args = args.replace(SPEC_MODULES[0], SPEC_MODULES[1])
        vllm["args"][0] = args
    elif component == "indexer":
        indexer = container(doc, "indexer")
        indexer["image"] = _swap(indexer["image"], INDEXER_IMAGES)
        indexer["command"] = ["python", "-m", _swap(indexer["command"][2], SERVICES)]
    return doc


def keyed(docs):
    out = {(d["kind"], d["metadata"]["name"]): d for d in docs}
    assert len(out) == len(docs)
    return out


VARIANTS = [
    {},
    {"indexer.discovery": "false"},
    {"valkey.enabled": "true"},
    {"valkey.enabled": "false"},
    {"hashSeed": '"7"'},
    {"sharedStorage.existingClaim": "my-filestore"},
    {"secret.create": "true", "secret.hfTokenValue": "hf_abc"},
    {"vllm.offload.enabled": "false"},
    {"indexer.replicaCount": "2", "valkey.enabled": "true"},
    {"indexer.enabled": "false"},
]
VARIANT_IDS = ["defaults", "central", "valkey", "no-valkey", "seed", "byo-pvc", "secret",
               "no-offload", "two-indexers", "no-indexer"]


@pytest.mark.parametrize("overrides", VARIANTS, ids=VARIANT_IDS)
def test_every_document_equals_the_reference_charts_but_for_the_stated_differences(overrides):
    port_docs = keyed(render(CHART, **overrides))
    ref_docs = keyed(render(REF_CHART, **overrides))
    assert sorted(port_docs) == sorted(ref_docs)
    for key, doc in port_docs.items():
        assert to_reference(doc) == ref_docs[key], key


@pytest.mark.parametrize(
    "overrides,match",
    [({"sharedStorage.enabled": "false"}, "sharedStorage.enabled"),
     ({"indexer.replicaCount": "2"}, "valkey.enabled")],
    ids=["offload-without-storage", "replicas-without-valkey"],
)
def test_every_fail_guard_of_the_reference_chart_holds(overrides, match):
    messages = []
    for chart in (CHART, REF_CHART):
        with pytest.raises(ValueError, match=match) as caught:
            render(chart, **overrides)
        messages.append(str(caught.value).replace(chart, "<chart>"))
    assert messages[0] == messages[1]


def test_the_parity_map_is_not_the_identity():
    """Without the map the defaults' documents differ: exactly those
    with the chart-name label, the two Deployments among them."""
    port_docs, ref_docs = keyed(render(CHART)), keyed(render(REF_CHART))
    differing = sorted(key for key in port_docs if port_docs[key] != ref_docs[key])
    labelled = sorted(key for key, doc in port_docs.items()
                      if "app.kubernetes.io/name" in doc["metadata"].get("labels", {}))
    assert differing == labelled
    assert {kind for kind, _ in differing} >= {"Deployment", "Service", "PersistentVolumeClaim"}


# ------------------------------------------------- chip_smoke.py phase 7e

@pytest.fixture(scope="module")
def smoke():
    return runpy.run_path(os.path.join(REPO, "chip_smoke.py"), run_name="chip_smoke_chart")


def test_chip_smoke_holds_the_charts_rendered_kv_transfer_config(smoke):
    """Phase 7e runs the connector from ``CHART_KV_TRANSFER_CONFIG``: the
    chart's default-rendered ``--kv-transfer-config``, character for
    character, and the chart's block size, tp size, model and mount."""
    docs = render()
    args = vllm_args(docs)
    assert smoke["CHART_KV_TRANSFER_CONFIG"] == kv_transfer_text(args)
    assert smoke["CHART_BLOCK_SIZE"] == int(flag_value(args, "--block-size"))
    assert smoke["CHART_TENSOR_PARALLEL"] == int(flag_value(args, "--tensor-parallel-size"))
    assert smoke["CHART_MODEL"] == args.split("vllm serve ", 1)[1].split()[0]
    dep = by_kind(docs, "Deployment", component="vllm")[0]
    mounts = {m["name"]: m["mountPath"] for m in container(dep, "vllm")["volumeMounts"]}
    assert smoke["CHART_STORAGE_MOUNT"] == mounts["shared-kv"]


def test_chip_smoke_resolves_the_spec_as_vllm_does(smoke):
    module, cls = smoke["resolve_chart_spec"](json.loads(smoke["CHART_KV_TRANSFER_CONFIG"]))
    assert module.__name__ == PORT_SPEC and cls.__name__ == "TPUSharedStorageOffloadingSpec"
    ref_config = extract_kv_transfer(vllm_args(render(REF_CHART)))
    with pytest.raises(AssertionError, match="not the port's spec"):
        smoke["resolve_chart_spec"](ref_config)
