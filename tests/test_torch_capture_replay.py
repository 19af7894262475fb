"""The port's incident capture and replay plane (``obs/capture.py``,
``obs/replay.py``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_capture_replay.py`` runs on
both packages (``m`` is either one's names):

* the input flight recorder's rings (bounds, truncation marking, the
  canonical-CBOR artifact round trip, the f64 codec);
* the pool and indexer taps (post-shed dispositions, displaced
  double-records, resync exclusion, lane-independent score records);
* replay determinism — a randomized mixed workload (kvevents storm +
  multi-turn scoring with the fast lane and score memo on) replayed
  through a fresh stack reproduces recorded scores and final index
  state exactly, in both single-index and 3-replica LocalCluster
  modes;
* replay-to-divergence — mutated captures report a first divergence;
* the config-fingerprint gate (mismatched knobs refuse with names);
* SLO transition listeners + the incident bundler (atomic bundles,
  rate limit, retention, failing sources);
* CAPTURE=0 inertness (no recorder, no ring, no thread).
"""

import copy
import json
import os
import random
import struct
import threading
import time

import pytest

from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.obs import capture as ref_capture
from llm_d_kv_cache_manager_tpu.obs import replay as ref_replay
from llm_d_kv_cache_manager_tpu.obs import slo as ref_slo
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "metrics.collector": ref_collector,
    "obs.capture": ref_capture,
    "obs.replay": ref_replay,
    "obs.slo": ref_slo,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "kvevents.events": ("BlockRemoved", "BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig", "ResyncJob"),
    "metrics.collector": ("METRICS",),
    "obs.capture": ("CaptureConfig", "IncidentManager", "InputCaptureRecorder", "canonical_state",
                    "capture_enabled_env", "config_fingerprint", "decode_f64", "diff_knobs",
                    "encode_f64", "fingerprint_status", "load_artifact", "set_build_info_metric"),
    "obs.replay": ("CaptureMismatchError", "_cancel_displaced", "load_capture", "render_prompt",
                   "replay_capture"),
    "obs.slo": ("SloEngine", "SloSpec"),
    "tokenization.tokenizers": ("Encoding",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


MODEL = "cap-model"
BLOCK = 4


class WordTokenizer:
    """'t<id>' words -> ids, returning the given package's ``Encoding``."""

    def __init__(self, m):
        self._encoding = m.Encoding

    def type(self):
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            if word.startswith("t"):
                tokens.append(int(word[1:]))
                offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def make_recorder(m, **cfg):
    cfg.setdefault("window_s", 3600.0)
    cfg.setdefault("max_bytes", 8 << 20)
    return m.InputCaptureRecorder(
        m.CaptureConfig(**cfg),
        meta={"block_size": BLOCK, "hash_seed": "", "model": MODEL},
    )


def make_stack(m, capture):
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(
                block_size=BLOCK
            ),
            cache_stats=False,
        ),
        tokenizer=WordTokenizer(m),
        capture_recorder=capture,
    )
    indexer.run()
    pool = m.Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        m.PoolConfig(concurrency=2),
        capture=capture,
    )
    pool.start()
    return indexer, pool


def stored_payload(m, hashes, tokens, parent=None, medium="hbm"):
    return m.EventBatch(
        ts=1.0,
        events=[
            m.BlockStored(
                block_hashes=list(hashes),
                parent_block_hash=parent,
                token_ids=list(tokens),
                block_size=BLOCK,
                medium=medium,
            )
        ],
    ).encode()


def kvevent_records(m, recorder):
    """Decoded kvevents records from a dump (no state section)."""
    art = m.load_artifact(recorder.dump_bytes())
    return [r for r in art["records"] if r[0] == 0]


def score_records(m, recorder):
    art = m.load_artifact(recorder.dump_bytes())
    return [r for r in art["records"] if r[0] == 1]


class TestF64Codec:
    @pytest.mark.parametrize(
        "value",
        [0.0, 1.0, 0.8, -3.75, 1e-300, 1.7976931348623157e308,
         0.1 + 0.2, float("inf")],
    )
    def test_round_trip_bit_exact(self, m, value):
        raw = m.encode_f64(value)
        assert len(raw) == 8
        assert struct.pack(">d", m.decode_f64(raw)) == raw
        assert m.decode_f64(raw) == value


class TestFingerprint:
    def test_stable_and_knob_sensitive(self, m, monkeypatch):
        before = m.config_fingerprint()
        assert before == m.config_fingerprint()
        monkeypatch.setenv("BLOCK_SIZE", "128")
        after = m.config_fingerprint()
        assert after != before
        diffs = m.diff_knobs([["BLOCK_SIZE", ""]])
        assert any("BLOCK_SIZE" in d for d in diffs)

    def test_status_and_metric(self, m):
        status = m.fingerprint_status()
        assert status["fingerprint"] == m.config_fingerprint()
        assert status["version"]
        fingerprint = m.set_build_info_metric()
        text = m.METRICS.exposition().decode()
        assert "kvtpu_build_info" in text
        assert fingerprint in text


class TestCaptureRecorder:
    def test_record_and_status(self, m):
        recorder = make_recorder(m)
        recorder.record_kvevents("p", "t", MODEL, 1, 0, b"xyz", "admitted")
        recorder.record_score(MODEL, [1, 2, 3, 4], ("p",), {"p": 1.0})
        status = recorder.status()
        assert status["sources"]["kvevents"]["records"] == 1
        assert status["sources"]["scores"]["records"] == 1
        assert status["records"] == 2
        assert not status["sources"]["kvevents"]["truncated"]
        assert status["fingerprint"] == m.config_fingerprint()

    def test_byte_bound_drops_oldest_and_marks_truncated(self, m):
        recorder = make_recorder(m, max_bytes=2048)
        for i in range(64):
            recorder.record_kvevents(
                "p", "t", MODEL, i + 1, 0, b"x" * 200, "admitted"
            )
        status = recorder.status()["sources"]["kvevents"]
        assert status["dropped"] > 0
        assert status["truncated"]
        assert status["bytes"] <= 1024  # per-source half budget
        records = kvevent_records(m, recorder)
        # Oldest went first: the retained stream is a suffix.
        seqs = [r[6] for r in records]
        assert seqs == sorted(seqs) and seqs[0] > 1

    def test_window_prunes_old_records(self, m):
        recorder = make_recorder(m, window_s=0.05)
        recorder.record_kvevents("p", "t", MODEL, 1, 0, b"a", "admitted")
        time.sleep(0.08)
        recorder.record_kvevents("p", "t", MODEL, 2, 0, b"b", "admitted")
        records = kvevent_records(m, recorder)
        assert [r[6] for r in records] == [2]
        assert recorder.status()["sources"]["kvevents"]["truncated"]

    def test_dump_round_trip(self, m):
        recorder = make_recorder(m)
        recorder.record_kvevents("p", "kv@p@m", MODEL, 7, 2, b"pp", "admitted")
        recorder.record_score(
            MODEL, (5, 6, 7, 8), None, {"a": 0.8, "b": 1.0}
        )
        art = m.load_artifact(recorder.dump_bytes())
        assert art["fingerprint"] == m.config_fingerprint()
        assert art["meta"]["block_size"] == str(BLOCK)
        assert art["truncated"] == []
        kv = [r for r in art["records"] if r[0] == 0][0]
        assert kv[3:] == ["p", "kv@p@m", MODEL, 7, 2, b"pp", "admitted"]
        score = [r for r in art["records"] if r[0] == 1][0]
        assert score[4] == [5, 6, 7, 8]
        assert score[5] is None
        assert {p: m.decode_f64(v) for p, v in score[6]} == {
            "a": 0.8,
            "b": 1.0,
        }
        # Global seq totally orders the merged stream.
        assert kv[1] < score[1]

    def test_dump_to_file_atomic(self, m, tmp_path):
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1, 2, 3, 4], None, {})
        path = str(tmp_path / "c.cbor")
        size = recorder.dump(path)
        assert os.path.getsize(path) == size
        assert not os.path.exists(path + ".tmp")

    def test_clear(self, m):
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1], None, {})
        recorder.clear()
        assert recorder.status()["sources"]["scores"]["records"] == 0

    def test_capture_env_gate(self, m, monkeypatch):
        for raw, expect in (
            ("0", False),
            ("false", False),
            ("off", False),
            ("no", False),
            ("1", True),
            ("yes", True),
        ):
            monkeypatch.setenv("CAPTURE", raw)
            assert m.capture_enabled_env() is expect
        monkeypatch.delenv("CAPTURE")
        assert m.capture_enabled_env() is True


class TestPoolCaptureTap:
    def test_admitted_stream_recorded(self, m):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            for i in range(3):
                tokens = [100 * i + j + 1 for j in range(BLOCK)]
                pool.add_task(
                    m.Message(
                        topic=f"kv@p@{MODEL}",
                        payload=stored_payload(m, [1000 + i], tokens),
                        pod_identifier="p",
                        model_name=MODEL,
                        seq=i + 1,
                    )
                )
            pool.drain()
        finally:
            pool.shutdown()
            indexer.shutdown()
        records = kvevent_records(m, recorder)
        assert [(r[3], r[6], r[9]) for r in records] == [
            ("p", 1, "admitted"),
            ("p", 2, "admitted"),
            ("p", 3, "admitted"),
        ]
        assert all(r[8] is not None for r in records)

    def test_poison_pill_recorded_with_payload(self, m):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            pool.add_task(
                m.Message(
                    topic=f"kv@p@{MODEL}",
                    payload=b"\x01garbage",
                    pod_identifier="p",
                    model_name=MODEL,
                    seq=1,
                )
            )
            pool.drain()
        finally:
            pool.shutdown()
            indexer.shutdown()
        records = kvevent_records(m, recorder)
        # A poison pill IS admitted ingress: replay re-drives it and
        # it drops identically in the fresh pool.
        assert records[0][8] == b"\x01garbage"
        assert records[0][9] == "admitted"

    def test_shed_dispositions_and_displacement(self, m):
        recorder = make_recorder(m)
        # Unstarted single-shard pool: shed decisions are
        # deterministic (no concurrent drain).
        pool = m.Pool(
            None,
            None,
            m.PoolConfig(
                concurrency=1, max_queue_depth=4, pod_budget=2
            ),
            capture=recorder,
        )

        def msg(pod, seq):
            return m.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=b"x",
                pod_identifier=pod,
                model_name=MODEL,
                seq=seq,
            )

        # Burst 1: pod a fills its budget, then over-budget sheds its
        # own oldest (same-batch: single shed record, payload kept).
        pool.add_tasks([msg("a", 1), msg("a", 2), msg("a", 3)])
        # Burst 2: pod b overflows the shard; the longest lane (a)
        # pays — a's seq 2 was admitted in burst 1, so its
        # displacement lands as a payload-free second record.
        pool.add_tasks([msg("b", 1), msg("b", 2), msg("b", 3)])
        records = kvevent_records(m, recorder)
        by_disposition = {}
        for r in records:
            by_disposition.setdefault(r[9], []).append((r[3], r[6], r[8]))
        assert ("a", 1, b"x") in by_disposition["pod_budget"]
        displaced = [
            r for r in records if r[9] != "admitted" and r[8] is None
        ]
        assert displaced and displaced[0][3] == "a"
        # Replay reconciliation drops exactly the displaced admits.
        art = m.load_artifact(recorder.dump_bytes())
        cancelled, n = m._cancel_displaced(art["records"])
        assert n == len(displaced)

    def test_resync_commands_not_recorded(self, m):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            done = threading.Event()
            job = m.ResyncJob(
                pod_identifier="p",
                model_name=MODEL,
                events=[],
                on_done=lambda *a: done.set(),
            )
            pool.enqueue_resync(job)
            pool.drain()
            assert done.wait(5)
        finally:
            pool.shutdown()
            indexer.shutdown()
        assert kvevent_records(m, recorder) == []

    def test_set_capture_late_attach(self, m):
        indexer, pool = make_stack(m, None)
        recorder = make_recorder(m)
        try:
            pool.set_capture(recorder)
            pool.add_task(
                m.Message(
                    topic=f"kv@p@{MODEL}",
                    payload=stored_payload(m, [1], [1, 2, 3, 4]),
                    pod_identifier="p",
                    model_name=MODEL,
                    seq=1,
                )
            )
            pool.drain()
        finally:
            pool.shutdown()
            indexer.shutdown()
        assert len(kvevent_records(m, recorder)) == 1


class TestIndexerCaptureTap:
    def test_all_lanes_record_identically(self, m):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            tokens = [i + 1 for i in range(BLOCK * 6)]
            pool.add_task(
                m.Message(
                    topic=f"kv@p@{MODEL}",
                    payload=stored_payload(m, 
                        [2000 + b for b in range(6)], tokens
                    ),
                    pod_identifier="p",
                    model_name=MODEL,
                    seq=1,
                )
            )
            pool.drain()
            prompt = m.render_prompt(tokens)
            walk = indexer.get_pod_scores(prompt, MODEL, ["p"])
            memo_hit = indexer.get_pod_scores(prompt, MODEL, ["p"])
            explained, _ = indexer.get_pod_scores_explained(
                prompt, MODEL, ["p"]
            )
            assert walk == memo_hit == explained
        finally:
            pool.shutdown()
            indexer.shutdown()
        records = score_records(m, recorder)
        assert len(records) == 3
        first = records[0]
        for record in records[1:]:
            assert record[4] == first[4]  # same served tokens
            assert record[6] == first[6]  # same scores
        assert first[5] == ["p"]

    def test_empty_prompt_recorded(self, m):
        recorder = make_recorder(m)
        indexer, _pool = make_stack(m, recorder)
        try:
            assert indexer.get_pod_scores("t1", MODEL) == {}
        finally:
            _pool.shutdown()
            indexer.shutdown()
        records = score_records(m, recorder)
        assert len(records) == 1 and records[0][6] == []


def drive_mixed_workload(m, indexer, pool, seed=11, pods=3, prompts=8):
    """Randomized mixed workload: per-pod contiguous event streams
    interleaved with multi-turn scoring (memo hits included).  Event
    bursts drain before scores — the visibility order the capture's
    global seq records.

    Shape chosen for cross-pod commutativity (the replay contract):
    the SHARED conversation prefix is add-only (pod-entry sets and
    engine mappings commute), while removals ride each pod's PRIVATE
    chain (disjoint token/engine space, single owner → per-pod lane
    order IS total order).  Cross-pod removals of a shared request
    key would make the engine-map cleanup order scheduling-dependent
    in the live run itself — no replay could pin that."""
    rng = random.Random(seed)
    seqs = {}
    turns = []
    convo = []

    def send(pod, payload):
        seqs[pod] = seqs.get(pod, 0) + 1
        pool.add_task(
            m.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=payload,
                pod_identifier=pod,
                model_name=MODEL,
                seq=seqs[pod],
            )
        )

    for p in range(prompts):
        convo.extend(
            rng.randrange(1, 30000) for _ in range(BLOCK * 4)
        )
        turns.append(list(convo))
        for pod_i in range(pods):
            if rng.random() < 0.3:
                continue
            pod = f"pod-{pod_i}"
            claimed = rng.randrange(1, len(convo) // BLOCK + 1)
            send(
                pod,
                stored_payload(m, 
                    [
                        90_000 + p * 500 + pod_i * 100 + b
                        for b in range(claimed)
                    ],
                    convo[: claimed * BLOCK],
                ),
            )
            if rng.random() < 0.4:
                # Pod-private add + removal (disjoint token space).
                private_hash = 800_000 + pod_i * 1000 + p
                private_tokens = [
                    40_000 + pod_i * 5000 + p * BLOCK + j + 1
                    for j in range(BLOCK)
                ]
                send(
                    pod,
                    stored_payload(m, [private_hash], private_tokens),
                )
                if rng.random() < 0.5:
                    send(
                        pod,
                        m.EventBatch(
                            ts=0.0,
                            events=[
                                m.BlockRemoved(
                                    block_hashes=[private_hash]
                                )
                            ],
                        ).encode(),
                    )
        pool.drain()
        prompt = m.render_prompt(turns[-1])
        pod_filter = (
            [f"pod-{i}" for i in range(pods)]
            if rng.random() < 0.5
            else None
        )
        for _ in range(rng.randrange(1, 3)):
            indexer.get_pod_scores(prompt, MODEL, pod_filter)


class TestReplayDeterminism:
    @pytest.mark.parametrize("mode", ["single", "cluster"])
    def test_mixed_workload_replays_exactly(self, m, mode):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            drive_mixed_workload(m, indexer, pool)
            pool.drain()
            blob = recorder.dump_bytes(index=indexer.kv_block_index)
        finally:
            pool.shutdown()
            indexer.shutdown()
        art = m.load_capture(blob)
        report = m.replay_capture(art, mode=mode)
        assert report.ok, report.to_dict()
        assert report.events_applied > 0
        assert report.scores_compared > 0
        assert report.state_compared
        assert report.truncated_sources == []

    def test_replay_is_idempotent(self, m):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            drive_mixed_workload(m, indexer, pool, seed=23, prompts=4)
            blob = recorder.dump_bytes(index=indexer.kv_block_index)
        finally:
            pool.shutdown()
            indexer.shutdown()
        art = m.load_capture(blob)
        assert m.replay_capture(art).ok
        assert m.replay_capture(art).ok  # artifact unchanged by replay


class TestReplayDivergence:
    def _capture(self, m, seed=31):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            drive_mixed_workload(m, indexer, pool, seed=seed, prompts=4)
            blob = recorder.dump_bytes(index=indexer.kv_block_index)
        finally:
            pool.shutdown()
            indexer.shutdown()
        return m.load_capture(blob)

    def test_mutated_score_diverges_at_record(self, m):
        art = self._capture(m)
        mutated = copy.deepcopy(art)
        target = None
        for record in mutated["records"]:
            if record[0] == 1 and record[6]:
                raw = bytearray(record[6][0][1])
                raw[-1] ^= 0x01
                record[6][0][1] = bytes(raw)
                target = record[1]
                break
        assert target is not None
        report = m.replay_capture(mutated)
        assert not report.ok
        assert report.divergence["kind"] == "score"
        assert report.divergence["at_seq"] == target
        assert "recorded" in report.divergence["detail"]

    def test_dropped_event_record_diverges(self, m):
        art = self._capture(m)
        mutated = copy.deepcopy(art)
        victims = [
            i
            for i, r in enumerate(mutated["records"])
            if r[0] == 0 and r[6] > 1
        ]
        del mutated["records"][victims[0]]
        report = m.replay_capture(mutated)
        assert not report.ok
        assert report.divergence["kind"] in (
            "seq_classification",
            "score",
        )

    def test_mutated_state_diverges(self, m):
        art = self._capture(m)
        mutated = copy.deepcopy(art)
        assert mutated["state"] is not None
        mutated["state"][0][0][1][0][1] = "not-a-tier"
        report = m.replay_capture(mutated)
        assert not report.ok
        assert report.divergence["kind"] == "state"
        assert "not-a-tier" in report.divergence["detail"]

    def test_truncated_capture_skips_state_comparison(self, m):
        recorder = make_recorder(m, max_bytes=4096)
        indexer, pool = make_stack(m, recorder)
        try:
            drive_mixed_workload(m, indexer, pool, seed=5, prompts=6)
            blob = recorder.dump_bytes(index=indexer.kv_block_index)
        finally:
            pool.shutdown()
            indexer.shutdown()
        art = m.load_capture(blob)
        assert art["truncated"]
        report = m.replay_capture(art)
        assert report.state_compared is False
        assert report.truncated_sources == art["truncated"]

    def test_garbage_artifact_refused(self, m):
        with pytest.raises(ValueError):
            m.load_capture(b"not cbor at all")


class TestFingerprintGate:
    def test_mismatched_knob_refused_with_names(self, m, monkeypatch):
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1, 2, 3, 4], None, {})
        blob = recorder.dump_bytes()
        monkeypatch.setenv("BLOCK_SIZE", "999")
        with pytest.raises(m.CaptureMismatchError) as exc:
            m.load_capture(blob)
        assert any(
            "BLOCK_SIZE" in diff for diff in exc.value.differences
        )
        # Forensic override still loads.
        art = m.load_capture(blob, allow_mismatch=True)
        assert art["records"]

    def test_matching_fingerprint_loads(self, m):
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1, 2, 3, 4], None, {})
        assert m.load_capture(recorder.dump_bytes())["records"]


class TestSloTransitionListener:
    def _engine(self, m):
        pressure = {"value": 0.0}
        engine = m.SloEngine(window_fast_s=5.0, window_slow_s=30.0)
        engine.register(
            m.SloSpec(
                "pressure",
                kind="gauge",
                objective=1.0,
                degraded_bound=2.0,
            ),
            lambda: (pressure["value"], 0.0),
        )
        return engine, pressure

    def test_transitions_fire_once_per_change(self, m):
        engine, pressure = self._engine(m)
        calls = []
        engine.add_listener(lambda old, new, p: calls.append((old, new)))
        t0 = 1000.0
        engine.sample(now=t0)
        engine.evaluate(now=t0)
        assert calls == []  # healthy -> healthy: no transition
        pressure["value"] = 5.0
        engine.sample(now=t0 + 1)
        engine.evaluate(now=t0 + 1)
        assert calls == [("healthy", "violated")]
        engine.sample(now=t0 + 2)
        engine.evaluate(now=t0 + 2)
        assert calls == [("healthy", "violated")]  # no re-fire
        # Recovery: the spike must age out of the fast gauge window
        # (max-aggregated) before the state returns to healthy.
        pressure["value"] = 0.0
        engine.sample(now=t0 + 20)
        engine.evaluate(now=t0 + 20)
        assert calls[-1] == ("violated", "healthy")

    def test_reentrant_evaluate_from_listener_delivers_in_order(self, m):
        """Pin: transition delivery is FIFO even when a
        listener itself drives another evaluation (the incident
        bundler's sources may hit /debug/slo paths) — the queued
        transition drains after the current one, never interleaved or
        lost, and re-entry cannot deadlock."""
        engine, pressure = self._engine(m)
        calls = []

        def listener(old, new, payload):
            calls.append((old, new))
            if new == "violated":
                # Recovery observed DURING the violated dispatch: the
                # resulting transition must queue behind it.
                pressure["value"] = 0.0
                engine.sample(now=2000.0)
                engine.evaluate(now=2000.0)

        engine.add_listener(listener)
        pressure["value"] = 5.0
        engine.sample(now=1000.0)
        engine.evaluate(now=1000.0)
        assert calls == [
            ("healthy", "violated"),
            ("violated", "healthy"),
        ]

    def test_raising_listener_never_propagates(self, m):
        engine, pressure = self._engine(m)

        def bad(old, new, payload):
            raise RuntimeError("boom")

        engine.add_listener(bad)
        pressure["value"] = 5.0
        engine.sample()
        assert engine.evaluate()["state"] == "violated"


class TestIncidentManager:
    def _manager(self, m, tmp_path, capture=None, **kw):
        kw.setdefault("min_interval_s", 60.0)
        return m.IncidentManager(
            str(tmp_path / "incidents"), capture=capture, **kw
        )

    def test_bundle_contents_and_listing(self, m, tmp_path):
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1, 2, 3, 4], None, {"p": 1.0})
        manager = self._manager(m, 
            tmp_path,
            capture=recorder,
            sources={
                "traces": lambda: {"ok": True},
                "boom": lambda: (_ for _ in ()).throw(
                    RuntimeError("down")
                ),
            },
        )
        manifest = manager.trigger("slo:test")
        assert manifest is not None
        assert manifest["reason"] == "slo:test"
        assert "capture.cbor" in manifest["files"]
        assert "traces.json" in manifest["files"]
        assert "boom" in manifest["source_errors"]
        assert manifest["fingerprint"]["fingerprint"] == (
            m.config_fingerprint()
        )
        bundle = os.path.join(
            str(tmp_path / "incidents"), manifest["id"]
        )
        assert os.path.isdir(bundle)
        assert not os.path.isdir(bundle + ".tmp")
        with open(os.path.join(bundle, "traces.json")) as handle:
            assert json.load(handle) == {"ok": True}
        art = m.load_capture(os.path.join(bundle, "capture.cbor"))
        assert art["records"]
        listing = manager.list()
        assert listing[0]["id"] == manifest["id"]
        assert manager.last_incident_id() == manifest["id"]
        assert manager.status()["bundles"] == 1

    def test_rate_limit_and_force(self, m, tmp_path):
        manager = self._manager(m, tmp_path, min_interval_s=3600.0)
        assert manager.trigger("slo:first") is not None
        assert manager.trigger("slo:second") is None
        assert manager.trigger("admin", force=True) is not None
        assert manager.status()["bundles"] == 2

    def test_retention_prunes_oldest(self, m, tmp_path):
        manager = self._manager(m, tmp_path, keep=2, min_interval_s=0.0)
        ids = [
            manager.trigger(f"r{i}", force=True)["id"] for i in range(4)
        ]
        kept = {m["id"] for m in manager.list()}
        assert kept == set(ids[-2:])

    def test_slo_listener_fires_only_into_violated(self, m, tmp_path):
        manager = self._manager(m, tmp_path, min_interval_s=0.0)
        listener = manager.slo_listener()
        listener("healthy", "degraded", {"slis": {}})
        assert manager.status()["bundles"] == 0
        listener(
            "healthy",
            "violated",
            {"slis": {"x": {"state": "violated"}}},
        )
        assert manager.status()["bundles"] == 1
        assert manager.list()[0]["reason"] == "slo:x"
        listener("violated", "healthy", {"slis": {}})
        assert manager.status()["bundles"] == 1

    def test_failed_bundle_leaves_no_tmp_dir(self, m, tmp_path):
        """Pin: a bundle that dies mid-write (disk full is
        the classic incident-time failure) must not orphan its
        ``inc-*.tmp`` directory — those squat under INCIDENT_DIR
        forever (pruning skips .tmp) and eat the space the next
        bundle needs."""

        class ExplodingCapture:
            def dump_bytes(self, index=None):
                raise OSError("disk full")

        manager = self._manager(m, tmp_path, capture=ExplodingCapture())
        assert manager.trigger("slo:boom", force=True) is None
        root = str(tmp_path / "incidents")
        assert os.listdir(root) == [], os.listdir(root)
        assert manager.status()["bundles"] == 0

    def test_state_section_from_wired_index(self, m, tmp_path):
        recorder = make_recorder(m)
        indexer, pool = make_stack(m, recorder)
        try:
            drive_mixed_workload(m, indexer, pool, seed=3, prompts=3)
            manager = self._manager(m, 
                tmp_path,
                capture=recorder,
                index=indexer.kv_block_index,
            )
            manifest = manager.trigger("slo:state")
            bundle = os.path.join(
                str(tmp_path / "incidents"), manifest["id"]
            )
            art = m.load_capture(os.path.join(bundle, "capture.cbor"))
            assert art["state"] == m.canonical_state(
                indexer.kv_block_index
            )
            report = m.replay_capture(art)
            assert report.ok and report.state_compared, report.to_dict()
        finally:
            pool.shutdown()
            indexer.shutdown()


class TestCaptureInertness:
    def test_capture_off_wires_nothing(self, m, monkeypatch):
        monkeypatch.setenv("CAPTURE", "0")
        assert m.capture_enabled_env() is False
        indexer, pool = make_stack(m, None)
        try:
            assert pool._capture is None
            assert indexer.capture is None
            pool.add_task(
                m.Message(
                    topic=f"kv@p@{MODEL}",
                    payload=stored_payload(m, [1], [1, 2, 3, 4]),
                    pod_identifier="p",
                    model_name=MODEL,
                    seq=1,
                )
            )
            pool.drain()
            indexer.get_pod_scores(m.render_prompt([1, 2, 3, 4]), MODEL)
        finally:
            pool.shutdown()
            indexer.shutdown()

    def test_recorder_has_no_thread(self, m):
        before = threading.active_count()
        recorder = make_recorder(m)
        recorder.record_score(MODEL, [1, 2, 3, 4], None, {})
        assert threading.active_count() == before
