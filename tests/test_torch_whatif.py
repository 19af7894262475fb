"""The port's what-if engine (``obs/whatif.py``) against the JAX
package's, on the CPU.

Every case of the reference's ``tests/test_whatif.py`` runs on both
packages (``m`` is either one's names): time-compressed replay on the
virtual clock is deterministic (same capture + speed + arm => same event
interleaving digest and counters, single-index and 3-replica cluster
modes), A/B replay reports a structured delta with a first
SLO-divergence point, the composition operators emit valid capture
artifacts the replay machinery accepts (scale/stretch bit-exactly), the
pinned reference capture is current for each package, and the
inline-drain pool primitive matches the worker path.
"""

from __future__ import annotations

import json
import os
import types

import pytest

from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu import obs as ref_obs
from llm_d_kv_cache_manager_tpu.obs import capture as ref_capture
from llm_d_kv_cache_manager_tpu.obs import replay as ref_replay
from llm_d_kv_cache_manager_tpu.obs import slo as ref_slo
from tests.helpers.torch_port import PACKAGE, namespace

SIDES = ("ref", "port")
_REF = {
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "obs": ref_obs,
    "obs.capture": ref_capture,
    "obs.replay": ref_replay,
    "obs.slo": ref_slo,
}
_NAMES = {
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "kvevents.events": ("BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig", "_ShardQueue"),
    "obs": ("whatif",),
    "obs.capture": ("CaptureConfig", "IncidentManager", "InputCaptureRecorder", "canonical_state",
                    "encode_capture", "load_artifact"),
    "obs.replay": ("CaptureMismatchError", "_ReplayTokenizer", "load_capture", "replay_capture"),
    "obs.slo": ("envelope_states",),
}


@pytest.fixture(params=SIDES, scope="module")
def m(request):
    return namespace(request.param, _REF, _NAMES)


REFERENCE = os.path.join(
    os.path.dirname(__file__), "testdata", "whatif_reference.cbor"
)
MODEL = "whatif-ref"
BLOCK = 4


@pytest.fixture(scope="module")
def reference(m):
    return m.load_capture(REFERENCE, allow_mismatch=True)


def _strip_wall(result):
    """The deterministic projection of a run result (wall-clock
    latencies/throughputs excluded by contract)."""
    events = {
        k: v
        for k, v in result["events"].items()
        if k != "per_sec_wall"
    }
    scores = {
        k: v
        for k, v in result["scores"].items()
        if k not in ("per_sec_wall", "latency_ms")
    }
    return {
        "events": events,
        "scores": scores,
        "digest": result["digest"],
        "mismatches": result["seq_classification_mismatches"],
        "timeline": result["slo"]["timeline"],
    }


class TestVirtualClockDeterminism:
    @pytest.mark.parametrize(
        "arm",
        [
            "shards=1",
            "shards=8",
            "mode=cluster,replicas=3",
            "depth=2,drain_rate=30",
            "backend=cost_aware,max_cost_mb=4",
        ],
    )
    def test_same_capture_same_arm_is_identical(self, m, reference, arm):
        cfg = m.whatif.WhatIfConfig(speed=8.0)
        spec = m.whatif.StackConfig.parse(arm)
        first = m.whatif.run_whatif(
            reference, spec, cfg, register=False
        )
        second = m.whatif.run_whatif(
            reference, spec, cfg, register=False
        )
        assert _strip_wall(first) == _strip_wall(second)

    def test_single_and_cluster_agree(self, m, reference):
        """The 3-replica cluster applies the same writes the single
        index does — deterministic counters and scores agree (digest
        folds scores + dispositions + canonical state, which the
        cluster dump normalizes to the single-index form)."""
        cfg = m.whatif.WhatIfConfig(speed=4.0)
        single = m.whatif.run_whatif(
            reference,
            m.whatif.StackConfig.parse(""),
            cfg,
            register=False,
        )
        cluster = m.whatif.run_whatif(
            reference,
            m.whatif.StackConfig.parse("mode=cluster,replicas=3"),
            cfg,
            register=False,
        )
        assert single["digest"] == cluster["digest"]
        assert (
            single["scores"]["hit_rate"] == cluster["scores"]["hit_rate"]
        )
        assert single["scores"]["recorded_parity"] == 1.0

    def test_speed_changes_schedule_not_measurements(self, m, reference):
        """With unbounded drain the apply schedule is
        arrival-synchronous, so compression changes checkpoint count
        but not hit rate or parity."""
        slow = m.whatif.run_whatif(
            reference,
            m.whatif.StackConfig.parse(""),
            m.whatif.WhatIfConfig(speed=2.0),
            register=False,
        )
        fast = m.whatif.run_whatif(
            reference,
            m.whatif.StackConfig.parse(""),
            m.whatif.WhatIfConfig(speed=10.0),
            register=False,
        )
        assert slow["scores"]["hit_rate"] == fast["scores"]["hit_rate"]
        assert slow["scores"]["recorded_parity"] == 1.0
        assert fast["virtual_span_s"] < slow["virtual_span_s"]
        assert fast["slo"]["checkpoints"] < slow["slo"]["checkpoints"]

    def test_finite_drain_rate_creates_real_backpressure(
        self, m, reference
    ):
        starved = m.whatif.run_whatif(
            reference,
            m.whatif.StackConfig.parse("depth=2,drain_rate=30"),
            m.whatif.WhatIfConfig(speed=8.0),
            register=False,
        )
        assert starved["events"]["shed"] > 0
        assert (
            starved["events"]["shed_reasons"].get("queue_full", 0) > 0
        )
        assert starved["events"]["applied"] < starved["events"]["offered"]
        assert starved["slo"]["final"]["whatif.event_shed"] == "violated"


class TestAbReplay:
    def test_shard_count_parity(self, m, reference):
        """shards=1 and shards=8 apply identical writes — ANY
        deterministic difference is a sharding bug, which is exactly
        what this A/B detects."""
        ab = m.whatif.run_ab(
            reference,
            m.whatif.StackConfig.parse("shards=1", name="s1"),
            m.whatif.StackConfig.parse("shards=8", name="s8"),
            m.whatif.WhatIfConfig(speed=8.0),
            register=False,
        )
        delta = ab["delta"]
        assert delta["digest_equal"]
        assert delta["hit_parity"] == 1.0
        assert delta["hit_rate"]["delta"] == 0.0
        assert delta["slo"]["first_divergence"] is None

    def test_flow_control_divergence(self, m, reference):
        ab = m.whatif.run_ab(
            reference,
            m.whatif.StackConfig.parse(
                "depth=2,drain_rate=30", name="tiny"
            ),
            m.whatif.StackConfig.parse("drain_rate=30", name="big"),
            m.whatif.WhatIfConfig(speed=8.0),
            register=False,
        )
        delta = ab["delta"]
        assert delta["shed"]["a"] > 0
        assert delta["shed"]["b"] == 0
        assert not delta["digest_equal"]
        divergence = delta["slo"]["first_divergence"]
        assert divergence is not None
        assert "whatif.event_shed" in divergence["slis"]
        assert divergence["a"]["whatif.event_shed"] != (
            divergence["b"]["whatif.event_shed"]
        )
        assert delta["slo"]["a_final"]["whatif.event_shed"] == "violated"
        assert delta["slo"]["b_final"]["whatif.event_shed"] == "healthy"

    def test_gate_headlines_shape(self, m, reference):
        ab = m.whatif.run_ab(
            reference,
            m.whatif.StackConfig.parse("shards=1", name="a"),
            m.whatif.StackConfig.parse("shards=8", name="b"),
            m.whatif.WhatIfConfig(speed=8.0),
            register=False,
        )
        headlines = m.whatif.gate_headlines(ab)
        assert set(headlines) == {
            "whatif.hit_rate",
            "whatif.recorded_parity",
            "whatif.ab_hit_parity",
        }
        assert headlines["whatif.recorded_parity"] == 1.0
        assert headlines["whatif.ab_hit_parity"] == 1.0
        assert 0.0 < headlines["whatif.hit_rate"] <= 1.0


class TestComposition:
    def test_scale_is_bit_exact_replayable(self, m, reference):
        scaled = m.whatif.scale_pods(reference, 2)
        art = m.load_capture(
            m.whatif.capture_to_bytes(scaled), allow_mismatch=True
        )
        assert art["meta"]["composed"] == "1"
        assert art["meta"]["compose_ops"] == "scale:2"
        report = m.replay_capture(art, mode="single")
        assert report.ok, report.to_dict()
        assert report.scores_compared > 0

    def test_stretch_is_bit_exact_replayable(self, m, reference):
        stretched = m.whatif.stretch(reference, 3.0)
        base_span = max(
            int(r[2]) for r in reference["records"]
        ) - min(int(r[2]) for r in reference["records"])
        new_span = max(
            int(r[2]) for r in stretched["records"]
        ) - min(int(r[2]) for r in stretched["records"])
        assert new_span == pytest.approx(base_span * 3, abs=2)
        report = m.replay_capture(
            m.load_capture(
                m.whatif.capture_to_bytes(stretched), allow_mismatch=True
            ),
            mode="single",
        )
        assert report.ok, report.to_dict()

    def test_splice_continues_seq_streams(self, m, reference):
        spliced = m.whatif.splice([reference, reference])
        art = m.load_capture(
            m.whatif.capture_to_bytes(spliced), allow_mismatch=True
        )
        assert len(art["records"]) == 2 * len(reference["records"])
        # Replaying the splice must classify every seq exactly as
        # recorded — the offset scheme continues each (pod, topic)
        # stream instead of restarting it.
        result = m.whatif.run_whatif(
            art,
            m.whatif.StackConfig.parse(""),
            m.whatif.WhatIfConfig(speed=10.0),
            register=False,
        )
        assert result["seq_classification_mismatches"] == 0
        assert result["events"]["offered"] == 2 * sum(
            1
            for r in reference["records"]
            if r[0] == 0 and r[8] is not None
        )

    def test_repeat_matches_splice(self, m, reference):
        assert (
            m.whatif.repeat(reference, 3)["records"]
            == m.whatif.splice([reference] * 3)["records"]
        )

    def test_interleave_renames_streams(self, m, reference):
        mixed = m.whatif.interleave([reference, reference])
        art = m.load_capture(
            m.whatif.capture_to_bytes(mixed), allow_mismatch=True
        )
        pods = {
            str(r[3]) for r in art["records"] if r[0] == 0
        }
        assert any(pod.endswith("~s1") for pod in pods)
        result = m.whatif.run_whatif(
            art,
            m.whatif.StackConfig.parse(""),
            m.whatif.WhatIfConfig(speed=10.0),
            register=False,
        )
        assert result["seq_classification_mismatches"] == 0

    def test_scale_expands_scores_and_filters(self, m, reference):
        scaled = m.whatif.scale_pods(reference, 2)
        for record in scaled["records"]:
            if record[0] != 1 or not record[6]:
                continue
            pods = [str(p) for p, _ in record[6]]
            base = [p for p in pods if not p.endswith("x1")]
            clones = [p for p in pods if p.endswith("x1")]
            assert len(base) == len(clones)
            break
        else:
            pytest.fail("no scored record with a score map")

    def test_incompatible_meta_refused(self, m, reference):
        other = dict(reference)
        other["meta"] = dict(reference["meta"], block_size="16")
        with pytest.raises(ValueError, match="block_size"):
            m.whatif.splice([reference, other])

    def test_encode_capture_round_trip(self, m):
        records = [
            [0, 1, 1000, "p", "t", "m", 1, 0, b"xx", "admitted"],
            [1, 2, 2000, "m", [1, 2], None, []],
        ]
        blob = m.encode_capture(
            records,
            fingerprint="fp",
            knobs=[["K", "V"]],
            created_us=7,
            window_s=3,
            max_bytes=9,
            truncated=["scores"],
            meta={"a": "b"},
            state=None,
        )
        art = m.load_artifact(blob)
        assert art["fingerprint"] == "fp"
        assert art["knobs"] == [("K", "V")]
        assert art["created_us"] == 7
        assert art["truncated"] == ["scores"]
        assert art["meta"] == {"a": "b"}
        assert art["records"] == records


def _reference_generator(side):
    """``hack/make_reference_capture.py`` as a module whose stack is the
    given package's: the port's copy is the script's text with the
    package name replaced, so the generator itself is the same."""
    if side == "ref":
        from hack import make_reference_capture

        return make_reference_capture
    path = os.path.join(os.path.dirname(__file__), "..", "hack", "make_reference_capture.py")
    with open(path) as handle:
        source = handle.read().replace("llm_d_kv_cache_manager_tpu.", PACKAGE + ".")
    module = types.ModuleType("make_reference_capture_port")
    module.__file__ = path
    exec(compile(source, path, "exec"), module.__dict__)
    return module


class TestReferenceArtifact:
    def test_reference_capture_is_current(self, m):
        """The checked-in artifact must equal a fresh deterministic
        rebuild on each package's stack — a drift in hashing, capture
        framing, or the generator itself fails here with the
        regeneration command."""
        build_reference_capture = _reference_generator(m.side).build_reference_capture

        with open(REFERENCE, "rb") as handle:
            disk = handle.read()
        assert disk == build_reference_capture(), (
            "tests/testdata/whatif_reference.cbor is stale; "
            "regenerate with: python hack/make_reference_capture.py "
            "(and refresh WHATIF_r01.json via the live headlines)"
        )

    def test_reference_ab_matches_recorded_baseline(self, m):
        """WHATIF_r01.json records deterministic measurements; the
        live engine must reproduce them exactly."""
        ab = m.whatif.reference_ab()
        live = m.whatif.gate_headlines(ab)
        with open(
            os.path.join(
                os.path.dirname(__file__), "..", "WHATIF_r01.json"
            )
        ) as handle:
            recorded = json.load(handle)["headlines"]
        assert live == recorded


def _tiny_stack(m):
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(
                block_size=BLOCK
            ),
            cache_stats=False,
        ),
        tokenizer=m._ReplayTokenizer(),
    )
    indexer.run()
    return indexer


def _stored(m, hashes, tokens):
    return m.EventBatch(
        ts=1.0,
        events=[
            m.BlockStored(
                block_hashes=list(hashes),
                parent_block_hash=None,
                token_ids=list(tokens),
                block_size=BLOCK,
                medium="hbm",
            )
        ],
    ).encode()


def _messages(m, count=12):
    out = []
    for i in range(count):
        pod = f"p{i % 3}"
        out.append(
            m.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=_stored(m, 
                    [10_000 + i], [i * BLOCK + j + 1 for j in range(BLOCK)]
                ),
                pod_identifier=pod,
                model_name=MODEL,
                seq=i // 3 + 1,
            )
        )
    return out


class TestProcessInline:
    def test_matches_worker_path(self, m):
        """Inline drain applies exactly what the started workers
        apply — same final canonical index state."""
        inline = _tiny_stack(m)
        workers = _tiny_stack(m)
        try:
            pool_inline = m.Pool(
                inline.kv_block_index,
                inline.token_processor,
                m.PoolConfig(concurrency=2),
            )
            for message in _messages(m):
                pool_inline.add_task(message)
            applied = pool_inline.process_inline()
            assert applied == 12
            assert pool_inline.backlog() == 0

            pool_workers = m.Pool(
                workers.kv_block_index,
                workers.token_processor,
                m.PoolConfig(concurrency=2),
            )
            pool_workers.start()
            for message in _messages(m):
                pool_workers.add_task(message)
            pool_workers.drain()
            pool_workers.shutdown()
            assert m.canonical_state(
                inline.kv_block_index
            ) == m.canonical_state(workers.kv_block_index)
        finally:
            inline.shutdown()
            workers.shutdown()

    def test_refuses_started_pool(self, m):
        stack = _tiny_stack(m)
        try:
            pool = m.Pool(
                stack.kv_block_index,
                stack.token_processor,
                m.PoolConfig(concurrency=1),
            )
            pool.start()
            try:
                with pytest.raises(RuntimeError, match="un-started"):
                    pool.process_inline()
            finally:
                pool.shutdown()
        finally:
            stack.shutdown()

    def test_limit_leaves_backlog(self, m):
        stack = _tiny_stack(m)
        try:
            pool = m.Pool(
                stack.kv_block_index,
                stack.token_processor,
                m.PoolConfig(concurrency=1, apply_batch_size=1),
            )
            for message in _messages(m):
                pool.add_task(message)
            assert pool.process_inline(5) == 5
            assert pool.backlog() == 7
            assert pool.process_inline() == 7
        finally:
            stack.shutdown()

    def test_try_get_batch_never_blocks(self, m):
        queue = m._ShardQueue(max_depth=8, pod_budget=0, per_pod=False)
        assert queue.try_get_batch(4) == ([], {})


class TestConfigAndRegistry:
    def test_parse_rejects_unknown_knob(self, m):
        with pytest.raises(ValueError, match="unknown arm knob"):
            m.whatif.StackConfig.parse("bogus=1")

    def test_parse_rejects_cluster_cost_aware(self, m):
        with pytest.raises(ValueError, match="cluster"):
            m.whatif.StackConfig.parse("mode=cluster,backend=cost_aware")

    def test_registry_bounded_newest_first(self, m):
        registry = m.whatif.WhatIfRegistry(keep=2)
        for i in range(4):
            registry.add(
                {
                    "kind": "run",
                    "arm": f"a{i}",
                    "events": {"offered": i},
                    "scores": {},
                    "digest": str(i),
                }
            )
        listed = registry.list()
        assert len(listed) == 2
        assert [row["arm"] for row in listed] == ["a3", "a2"]
        assert registry.status()["results"] == 2
        full = registry.list(full=True)
        assert full[0]["events"] == {"offered": 3}

    def test_envelope_states_shape(self, m):
        payload = {
            "state": "degraded",
            "slis": {
                "x": {"state": "violated"},
                "y": {"state": "healthy"},
            },
        }
        assert m.envelope_states(payload) == {
            "overall": "degraded",
            "x": "violated",
            "y": "healthy",
        }

    def test_resolve_capture_source_bundle_dir(self, m, tmp_path):
        bundle = tmp_path / "inc-x"
        bundle.mkdir()
        with pytest.raises(FileNotFoundError, match="capture.cbor"):
            m.whatif.resolve_capture_source(str(bundle))
        (bundle / "capture.cbor").write_bytes(b"x")
        assert m.whatif.resolve_capture_source(str(bundle)) == str(
            bundle / "capture.cbor"
        )


class TestCli:
    def test_compose_then_run(self, m, tmp_path, capsys):
        out = tmp_path / "storm.cbor"
        rc = m.whatif.main(
            [
                "compose",
                str(out),
                REFERENCE,
                "--op",
                "scale:2",
                "--op",
                "stretch:0.5",
            ]
        )
        assert rc == 0
        composed = m.load_capture(str(out), allow_mismatch=True)
        assert composed["meta"]["compose_ops"] == "scale:2+stretch:0.5"
        rc = m.whatif.main(
            [
                "run",
                str(out),
                "--arm",
                "shards=8",
                "--speed",
                "10",
                "--json",
                str(tmp_path / "result.json"),
            ]
        )
        assert rc == 0
        with open(tmp_path / "result.json") as handle:
            result = json.load(handle)
        assert result["kind"] == "run"
        assert result["scores"]["total"] > 0

    def test_ab_cli(self, m, tmp_path):
        rc = m.whatif.main(
            [
                "ab",
                REFERENCE,
                "--a",
                "shards=1",
                "--b",
                "shards=8",
                "--speed",
                "10",
                "--json",
                str(tmp_path / "ab.json"),
            ]
        )
        assert rc == 0
        with open(tmp_path / "ab.json") as handle:
            ab = json.load(handle)
        assert ab["delta"]["digest_equal"] is True


class TestMismatchErrorNamesArtifact:
    def test_path_and_short_hash_in_message(self, m):
        with pytest.raises(m.CaptureMismatchError) as excinfo:
            m.load_capture(REFERENCE)
        message = str(excinfo.value)
        assert "whatif_reference.cbor" in message
        assert "whatif-re" in message  # fingerprint short-hash prefix
        assert excinfo.value.source == REFERENCE

    def test_bytes_source_still_reports(self, m, reference):
        blob = m.whatif.capture_to_bytes(reference)
        with pytest.raises(m.CaptureMismatchError) as excinfo:
            m.load_capture(blob)
        assert excinfo.value.source is None


class TestIncidentDetail:
    def _manager(self, m, tmp_path):
        recorder = m.InputCaptureRecorder(
            m.CaptureConfig(window_s=3600.0, max_bytes=1 << 20),
            meta={"block_size": BLOCK, "hash_seed": "", "model": MODEL},
        )
        recorder.record_kvevents_batch(
            [("p", "t", MODEL, 1, 0, b"xx", "admitted")]
        )
        return m.IncidentManager(
            str(tmp_path),
            capture=recorder,
            sources={"slo": lambda: {"ok": True}},
            min_interval_s=0.0,
        )

    def test_detail_lists_manifest_and_inventory(self, m, tmp_path):
        manager = self._manager(m, tmp_path)
        manifest = manager.trigger("test", force=True)
        detail = manager.detail(manifest["id"])
        assert detail["id"] == manifest["id"]
        assert detail["manifest"]["reason"] == "test"
        files = {row["file"] for row in detail["inventory"]}
        assert "manifest.json" in files
        assert "capture.cbor" in files
        assert all(row["bytes"] > 0 for row in detail["inventory"])

    def test_detail_unknown_and_traversal(self, m, tmp_path):
        manager = self._manager(m, tmp_path)
        assert manager.detail("inc-nope") is None
        assert manager.detail("../etc") is None
        assert manager.detail("inc-../../etc") is None
