"""Sidecar download hygiene of the port's ``services/uds_tokenizer.py``
beside the JAX package's: every case of ``tests/test_sidecar_downloads.py``
runs on both packages' sidecar modules (``sidecar`` is either one).

The hub and ModelScope stand-ins are the reference test's: fake
``huggingface_hub`` and ``modelscope`` modules put in ``sys.modules``,
which each package's ``fetch_tokenizer_files`` imports lazily, so no case
reaches the network.  Tokenizer-related files only, source dispatch,
cache-first reuse, cleanup of failed and partial downloads, traversal
refused.
"""

from __future__ import annotations

import sys
import types

import pytest

from llm_d_kv_cache_manager_tpu.services import uds_tokenizer as ref_sidecar
from tests.helpers.torch_port import port


@pytest.fixture(params=("ref", "port"))
def sidecar(request):
    return ref_sidecar if request.param == "ref" else port("services.uds_tokenizer")

class FakeHub:
    """Stands in for huggingface_hub / modelscope snapshot_download.

    ``fail='partial'`` writes config.json and THEN raises — the
    interrupted-mid-snapshot case."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def snapshot_download(self, model_id, local_dir, allow_patterns):
        import os

        self.calls.append(
            {
                "model_id": model_id,
                "local_dir": local_dir,
                "allow_patterns": list(allow_patterns),
            }
        )
        if self.fail == "partial":
            with open(os.path.join(local_dir, "config.json"), "w") as f:
                f.write("{}")
            with open(
                os.path.join(local_dir, "tokenizer.json"), "w"
            ) as f:
                f.write("{")  # truncated
            raise RuntimeError("network blip mid-download")
        if self.fail:
            raise RuntimeError("download failed")
        for name in ("config.json", "tokenizer.json"):
            with open(os.path.join(local_dir, name), "w") as f:
                f.write("{}")


@pytest.fixture
def fake_hf(monkeypatch):
    hub = FakeHub()
    module = types.ModuleType("huggingface_hub")
    module.snapshot_download = hub.snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", module)
    monkeypatch.delenv("USE_MODELSCOPE", raising=False)
    return hub


@pytest.fixture
def fake_modelscope(monkeypatch):
    hub = FakeHub()
    module = types.ModuleType("modelscope")
    module.snapshot_download = hub.snapshot_download
    monkeypatch.setitem(sys.modules, "modelscope", module)
    monkeypatch.setenv("USE_MODELSCOPE", "true")
    return hub


class TestRemoteDetection:
    def test_hub_names_are_remote(self, sidecar):
        assert sidecar.is_remote_model("meta-llama/Llama-3.1-8B")

    def test_paths_are_local(self, sidecar, tmp_path):
        assert not sidecar.is_remote_model(str(tmp_path))
        assert not sidecar.is_remote_model("./models/x")
        assert not sidecar.is_remote_model("../x")

    def test_existing_relative_dir_is_local(self, sidecar, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "local-model").mkdir()
        assert not sidecar.is_remote_model("local-model")


class TestFetch:
    def test_downloads_only_tokenizer_files(self, sidecar, fake_hf, tmp_path):
        path = sidecar.fetch_tokenizer_files(
            "org/model", cache_dir=str(tmp_path)
        )
        assert path == str(tmp_path / "org" / "model")
        (call,) = fake_hf.calls
        assert call["allow_patterns"] == sidecar.TOKENIZER_FILE_PATTERNS
        # No weight patterns may ever sneak in.
        assert not any(
            "safetensors" in p or ".bin" in p or ".pt" in p
            for p in call["allow_patterns"]
        )

    def test_cache_hit_skips_download(self, sidecar, fake_hf, tmp_path):
        sidecar.fetch_tokenizer_files("org/model", cache_dir=str(tmp_path))
        sidecar.fetch_tokenizer_files("org/model", cache_dir=str(tmp_path))
        assert len(fake_hf.calls) == 1  # second call reused the cache

    def test_modelscope_dispatch(self, sidecar, fake_modelscope, tmp_path):
        sidecar.fetch_tokenizer_files("org/model", cache_dir=str(tmp_path))
        (call,) = fake_modelscope.calls
        assert call["model_id"] == "org/model"
        assert call["allow_patterns"] == sidecar.TOKENIZER_FILE_PATTERNS

    def test_local_path_passthrough(self, sidecar, fake_hf, tmp_path):
        model_dir = tmp_path / "m"
        model_dir.mkdir()
        assert (
            sidecar.fetch_tokenizer_files(str(model_dir)) == str(model_dir)
        )
        assert fake_hf.calls == []

    def test_failed_download_removes_empty_dir(
        self, sidecar, monkeypatch, tmp_path
    ):
        hub = FakeHub(fail=True)
        module = types.ModuleType("huggingface_hub")
        module.snapshot_download = hub.snapshot_download
        monkeypatch.setitem(sys.modules, "huggingface_hub", module)
        monkeypatch.delenv("USE_MODELSCOPE", raising=False)
        with pytest.raises(RuntimeError):
            sidecar.fetch_tokenizer_files(
                "org/broken", cache_dir=str(tmp_path)
            )
        # The empty dir must not fake a future cache hit.
        assert not (tmp_path / "org" / "broken").exists()

    def test_env_cache_dir(self, sidecar, fake_hf, tmp_path, monkeypatch):
        monkeypatch.setenv("TOKENIZER_CACHE_DIR", str(tmp_path / "env"))
        path = sidecar.fetch_tokenizer_files("org/model")
        assert path.startswith(str(tmp_path / "env"))

    def test_partial_download_is_not_a_cache_hit(
        self, sidecar, monkeypatch, tmp_path
    ):
        """A download interrupted mid-snapshot must not leave files at
        the cache path (they'd satisfy the cached check forever)."""
        hub = FakeHub(fail="partial")
        module = types.ModuleType("huggingface_hub")
        module.snapshot_download = hub.snapshot_download
        monkeypatch.setitem(sys.modules, "huggingface_hub", module)
        monkeypatch.delenv("USE_MODELSCOPE", raising=False)
        with pytest.raises(RuntimeError):
            sidecar.fetch_tokenizer_files(
                "org/model", cache_dir=str(tmp_path)
            )
        assert not (tmp_path / "org" / "model").exists()
        # A retry re-downloads instead of reusing the wreckage.
        good = FakeHub()
        module.snapshot_download = good.snapshot_download
        sidecar.fetch_tokenizer_files("org/model", cache_dir=str(tmp_path))
        assert len(good.calls) == 1

    def test_sentencepiece_only_cache_hit(self, sidecar, fake_hf, tmp_path):
        """config.json + tokenizer.model (no tokenizer.json) counts as
        cached — sentencepiece-only models must not re-download."""
        model_dir = tmp_path / "org" / "sp"
        model_dir.mkdir(parents=True)
        (model_dir / "config.json").write_text("{}")
        (model_dir / "tokenizer.model").write_text("sp")
        path = sidecar.fetch_tokenizer_files(
            "org/sp", cache_dir=str(tmp_path)
        )
        assert path == str(model_dir) and fake_hf.calls == []

    @pytest.mark.parametrize(
        "bad",
        [
            "a/../../../../etc",
            "../x",  # local-looking but guard both layers
            "org/..",
            "org/.",
            "a/b/c",
            "org//model",
            "org/mo del",
        ],
    )
    def test_traversal_identifiers_rejected(self, sidecar, fake_hf, tmp_path, bad):
        if not sidecar.is_remote_model(bad):
            return  # handled as a local path, never touches the cache
        with pytest.raises(ValueError):
            sidecar.fetch_tokenizer_files(bad, cache_dir=str(tmp_path))
        assert fake_hf.calls == []


class TestRegistryLoader:
    def test_registry_uses_injected_loader(self, sidecar):
        loads = []

        def loader(name):
            loads.append(name)
            return object()

        registry = sidecar.TokenizerRegistry(loader=loader)
        first = registry.get("org/m")
        second = registry.get("org/m")
        assert first is second and loads == ["org/m"]


def test_allow_list_and_cache_layout_equal_the_references(tmp_path):
    """Both packages allow the same files and publish a fetch at the same
    path (a sidecar of either package reuses the other's cache)."""
    ours = port("services.uds_tokenizer")
    assert ours.TOKENIZER_FILE_PATTERNS == ref_sidecar.TOKENIZER_FILE_PATTERNS
    assert (ours.REQUIRED_CACHED_FILE, ours.ANY_OF_CACHED_FILES) == (
        ref_sidecar.REQUIRED_CACHED_FILE, ref_sidecar.ANY_OF_CACHED_FILES)
    model_dir = tmp_path / "org" / "m"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text("{}")
    (model_dir / "tokenizer.json").write_text("{}")
    for module in (ours, ref_sidecar):
        assert module.fetch_tokenizer_files("org/m", cache_dir=str(tmp_path)) == str(model_dir)
