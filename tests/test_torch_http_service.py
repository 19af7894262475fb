"""The port's HTTP scoring service (``api/http_service.py``) against the
JAX package's, on the CPU.

Every case of the reference's ``tests/test_http_service.py`` runs on both
packages (``m`` is either one's names), each through its own ``serve()``:
completions and chat scoring round trips, the error paths, the admin
gate, and the persistence endpoints.
"""

import json
import urllib.error
import urllib.request

import pytest

from tests.helpers.tiny_tokenizer import (
    build_transformers_tokenizer,
    save_tokenizer_json,
)

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu import persistence as ref_persistence
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "persistence": ref_persistence,
    "tokenization.pool": ref_pool,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("serve",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.index": ("PodEntry",),
    "kvcache.kvblock.token_processor": ("EMPTY_BLOCK_HASH", "TokenProcessorConfig"),
    "persistence": ("PersistenceConfig", "PersistenceManager", "recover"),
    "tokenization.pool": ("TokenizationPoolConfig",),
    "tokenization.tokenizers": ("LocalFastTokenizer",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


MODEL = "test-model"
PROMPT = "the quick brown fox jumps over the lazy dog"


@pytest.fixture()
def service(m, tmp_path):
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=4),
            tokenizers_pool_config=m.TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
        ),
        tokenizer=m.LocalFastTokenizer(tokenizer_dir),
    )
    indexer.chat_processor.register_tokenizer(
        MODEL, build_transformers_tokenizer()
    )
    indexer.run()
    server = m.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield indexer, base
    server.shutdown()
    server.server_close()
    indexer.shutdown()


def post(base, path, obj):
    request = urllib.request.Request(
        base + path,
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=10) as response:
        return response.status, json.load(response)


def seed(m, indexer, prompt, pod):
    tokens = indexer.tokenization_pool.tokenize(prompt, MODEL, None)
    keys = indexer.token_processor.tokens_to_kv_block_keys(
        m.EMPTY_BLOCK_HASH, tokens, MODEL
    )
    indexer.kv_block_index.add(keys, keys, [m.PodEntry(pod, "hbm")])


class TestHTTPService:
    def test_score_completions(self, m, service):
        indexer, base = service
        seed(m, indexer, PROMPT, "pod-a")
        status, scores = post(
            base,
            "/score_completions",
            {"prompt": PROMPT, "model": MODEL},
        )
        assert status == 200
        assert scores["pod-a"] > 0

    def test_score_chat_completions(self, m, service):
        indexer, base = service
        rendered = "<|user|> hello world <|assistant|>"
        seed(m, indexer, rendered, "pod-chat")
        status, scores = post(
            base,
            "/score_chat_completions",
            {
                "model": MODEL,
                "messages": [{"role": "user", "content": "hello world"}],
            },
        )
        assert status == 200
        assert scores.get("pod-chat", 0) > 0

    def test_missing_prompt_400(self, service):
        _, base = service
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/score_completions", {"model": MODEL})
        assert err.value.code == 400

    def test_metrics_and_healthz(self, m, service):
        indexer, base = service
        seed(m, indexer, PROMPT, "pod-a")
        post(base, "/score_completions", {"prompt": PROMPT, "model": MODEL})
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            body = resp.read().decode()
        assert "kvtpu_kvcache_index_lookup_requests_total" in body
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            assert json.load(resp)["status"] == "ok"

    def test_unknown_path_404(self, service):
        _, base = service
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/nope", {})
        assert err.value.code == 404

    def test_admin_purge_pod(self, m, service):
        indexer, base = service
        other_prompt = "pack my box with five dozen liquor jugs"
        seed(m, indexer, PROMPT, "pod-a")
        seed(m, indexer, other_prompt, "pod-b")
        status, body = post(base, "/admin/purge_pod", {"pod": "pod-a"})
        assert status == 200 and body["removed"] > 0
        status, scores = post(
            base, "/score_completions", {"prompt": PROMPT, "model": MODEL}
        )
        assert "pod-a" not in scores
        # Isolation: pod-b's entries survive the purge and still score.
        status, scores = post(
            base,
            "/score_completions",
            {"prompt": other_prompt, "model": MODEL},
        )
        assert scores.get("pod-b", 0) > 0

    def test_admin_purge_pod_requires_pod(self, service):
        _, base = service
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/admin/purge_pod", {})
        assert err.value.code == 400

    def test_non_object_json_body_is_400(self, service):
        """`null`/arrays are valid JSON; without the dict check the
        handler would hang the keep-alive connection (no response) or
        crash it mid-request."""
        _, base = service
        for body in (None, [1, 2], "x"):
            with pytest.raises(urllib.error.HTTPError) as err:
                post(base, "/admin/purge_pod", body)
            assert err.value.code == 400

    def test_admin_token_gate(self, m, tmp_path):
        """With ADMIN_TOKEN configured, /admin/* requires the bearer
        token even from loopback; scoring stays open."""
        tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
        indexer = m.Indexer(
            m.IndexerConfig(
                token_processor_config=m.TokenProcessorConfig(block_size=4),
                tokenizers_pool_config=m.TokenizationPoolConfig(
                    workers=2, model_name=MODEL
                ),
            ),
            tokenizer=m.LocalFastTokenizer(tokenizer_dir),
        )
        indexer.run()
        server = m.serve(
            indexer, host="127.0.0.1", port=0, admin_token="s3cret"
        )
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                post(base, "/admin/purge_pod", {"pod": "pod-a"})
            assert err.value.code == 403
            request = urllib.request.Request(
                base + "/admin/purge_pod",
                data=json.dumps({"pod": "pod-a"}).encode(),
                headers={
                    "Content-Type": "application/json",
                    "Authorization": "Bearer s3cret",
                },
                method="POST",
            )
            with urllib.request.urlopen(request, timeout=10) as resp:
                assert resp.status == 200
            # Scoring needs no token.
            status, _ = post(
                base,
                "/score_completions",
                {"prompt": PROMPT, "model": MODEL},
            )
            assert status == 200
        finally:
            server.shutdown()
            server.server_close()
            indexer.shutdown()

    def test_admin_snapshot_without_persistence_503(self, service):
        _, base = service
        with pytest.raises(urllib.error.HTTPError) as err:
            post(base, "/admin/snapshot", {})
        assert err.value.code == 503


class TestPersistenceEndpoints:
    @pytest.fixture()
    def persistent_service(self, m, tmp_path):
        tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
        indexer = m.Indexer(
            m.IndexerConfig(
                token_processor_config=m.TokenProcessorConfig(block_size=4),
                tokenizers_pool_config=m.TokenizationPoolConfig(
                    workers=2, model_name=MODEL
                ),
            ),
            tokenizer=m.LocalFastTokenizer(tokenizer_dir),
        )
        indexer.run()
        manager = m.PersistenceManager(
            m.PersistenceConfig(directory=str(tmp_path / "state"))
        )
        report = manager.recover(indexer.kv_block_index)
        server = m.serve(
            indexer,
            host="127.0.0.1",
            port=0,
            persistence=manager,
            recovery_report=report,
        )
        base = f"http://127.0.0.1:{server.server_address[1]}"
        yield indexer, manager, base
        server.shutdown()
        server.server_close()
        manager.close()
        indexer.shutdown()

    def test_healthz_reports_recovery_and_persistence(
        self, persistent_service
    ):
        indexer, manager, base = persistent_service
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.load(resp)
        assert health["status"] == "ok"
        assert health["recovery"]["status"] == "cold"  # empty dir
        assert health["persistence"]["snapshot_path"] is None

    def test_admin_snapshot_publishes_and_updates_healthz(
        self, m, persistent_service
    ):
        indexer, manager, base = persistent_service
        seed(m, indexer, PROMPT, "pod-a")
        status, body = post(base, "/admin/snapshot", {})
        assert status == 200
        assert body["block_keys"] > 0
        assert body["path"].endswith(".snap")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.load(resp)
        assert health["persistence"]["snapshot_path"] == body["path"]
        assert health["persistence"]["snapshot_age_s"] is not None

    def test_snapshot_then_recover_round_trip(self, m, persistent_service):
        """The service-level warm restart: snapshot via the admin
        endpoint, recover into a fresh indexer, identical scores."""
        indexer, manager, base = persistent_service
        seed(m, indexer, PROMPT, "pod-a")
        post(base, "/admin/snapshot", {})
        restored = m.Indexer(
            m.IndexerConfig(
                token_processor_config=m.TokenProcessorConfig(block_size=4),
            ),
            tokenizer=indexer.tokenization_pool._tokenizer,
        )
        report = m.recover(restored.kv_block_index, manager.config)
        assert report.status == "warm"
        tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
        keys = indexer.token_processor.tokens_to_kv_block_keys(
            m.EMPTY_BLOCK_HASH, tokens, MODEL
        )
        assert restored.kv_block_index.lookup(
            keys
        ) == indexer.kv_block_index.lookup(keys)
        restored.shutdown()
