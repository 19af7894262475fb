"""The port's KV-transfer planning plane (``transfer/``) against the JAX
package's, on the CPU.

The same inputs (a numpy seed, ``now``s given by the test) go through
both packages: plans and their outcome labels, the executor's published
events and the index after each package's event pool applied them
(dead source, partly evicted chain, a source demoted between plan and
execute), warm-up drains, load blending and the planned scoring variant
must be equal.  The cases are those of the JAX package's
``tests/test_transfer.py``, its ``TestTransferHttpSurface`` included
(``/debug/transfer``, ``/healthz``, ``/debug`` and planned scoring
through each package's ``serve()``), each held to that test's
expectations in both packages.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu import tiering as ref_tiering
from llm_d_kv_cache_manager_tpu import transfer as ref_transfer
from llm_d_kv_cache_manager_tpu.analytics import ledger as ref_ledger
from llm_d_kv_cache_manager_tpu.api import http_service as ref_http
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_tp
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tok_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from llm_d_kv_cache_manager_tpu.transfer import planner as ref_planner
from tests.helpers.torch_port import port

MODEL = "transfer-model"
BLOCK_SIZE = 4
SIDES = ("ref", "port")
KEYS = [11, 22, 33, 44]

_REF = dict(tiering=ref_tiering, transfer=ref_transfer, ledger=ref_ledger, indexer=ref_indexer,
            tp=ref_tp, events=ref_events, pool=ref_pool, tok_pool=ref_tok_pool,
            tokenizers=ref_tokenizers, planner=ref_planner, http=ref_http)
_PORT = dict(tiering="tiering", transfer="transfer", ledger="analytics.ledger",
             indexer="kvcache.indexer", tp="kvcache.kvblock.token_processor",
             events="kvevents.events", pool="kvevents.pool", tok_pool="tokenization.pool",
             tokenizers="tokenization.tokenizers", planner="transfer.planner",
             http="api.http_service")


def mods(side: str) -> SimpleNamespace:
    if side == "ref":
        return SimpleNamespace(side=side, **_REF)
    return SimpleNamespace(side=side, **{k: port(v) for k, v in _PORT.items()})


def same(story):
    """``story(mods)`` on both packages; the results must be equal."""
    out = {side: story(mods(side)) for side in SIDES}
    assert out["port"] == out["ref"]
    return out["port"]


class WordTokenizer:
    """Deterministic whitespace tokenizer: 'tN' -> N."""

    def __init__(self, m):
        self._encoding = m.tokenizers.Encoding

    def type(self) -> str:
        return "word"

    def encode(self, prompt, model_name, add_special_tokens=True):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens, offsets)


def prompt_of(tokens) -> str:
    return " ".join(f"t{t}" for t in tokens)


def fed_advisor(m, bytes_per_block=1024, prefill_rate=50.0, load_s=0.001, store_s=0.0005):
    """Advisor with both RTT models fed: transfers price cheap."""
    advisor = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(
        bytes_per_block=bytes_per_block, block_tokens=BLOCK_SIZE,
        prefill_tokens_per_s=prefill_rate))
    if load_s is not None:
        advisor.observe_load(4096, load_s)
    if store_s is not None:
        advisor.observe_store(4096, store_s)
    return advisor


def prov(score, blocks, tiers=None):
    """One pod's scorer-explain provenance entry."""
    return {"score": score, "blocks_matched": blocks, "break_index": blocks,
            "tiers": dict(tiers) if tiers else {"hbm": blocks}}


def make_planner(m, advisor=None, **kw):
    kw.setdefault("load_threshold", 2.0)
    return m.transfer.TransferPlanner(advisor or fed_advisor(m), **kw)


def plan_view(plan):
    return None if plan is None else dataclasses.asdict(plan)


def make_stack(m, ledger=None, **config_kw):
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(workers=1,
                                                                     model_name=MODEL),
            **config_kw),
        tokenizer=WordTokenizer(m), cache_stats_ledger=ledger)
    indexer.run()
    pool = m.pool.Pool(indexer.kv_block_index, indexer.token_processor,
                       m.pool.PoolConfig(concurrency=2))
    pool.start()
    return indexer, pool


def publish(m, pool, pod, events):
    pool.add_task(m.pool.Message(
        topic=f"kv@{pod}@{MODEL}", payload=m.events.EventBatch(ts=1.0, events=events).encode(),
        pod_identifier=pod, model_name=MODEL))
    pool.drain()


def seed_chain(m, pool, pod, hashes, tokens, medium="hbm"):
    publish(m, pool, pod, [m.events.BlockStored(
        block_hashes=list(hashes), parent_block_hash=None, token_ids=list(tokens),
        block_size=BLOCK_SIZE, medium=medium)])


def dump_view(index):
    entries, engine_map = index.dump_entries()
    return (sorted((key, sorted((e.pod_identifier, e.device_tier) for e in pods))
                   for key, pods in entries), sorted(tuple(x) for x in engine_map))


class Recorder:
    """A pool stand-in that records the messages the executor publishes
    and forwards them to the real pool."""

    def __init__(self, m, pool):
        self.m, self.pool, self.events = m, pool, []

    def add_task(self, message):
        batch = self.m.events.decode_event_batch(bytes(message.payload))
        self.events.append((message.topic, [
            (type(e).__name__, dataclasses.asdict(e))
            for e in map(self.m.events.decode_event, batch.events)]))
        self.pool.add_task(message)


# ---------------------------------------------------------------- planner


def _planned_happy_path(m):
    planner = make_planner(m)
    plan, outcome = planner.plan({"pod-1": prov(4.0, 4), "pod-2": prov(0.0, 0)},
                                 {"pod-1": 5.0, "pod-2": 0.0}, KEYS, token_ids=list(range(16)),
                                 block_size=BLOCK_SIZE, now=0.0)
    assert outcome == "planned" and (plan.source_pod, plan.target_pod) == ("pod-1", "pod-2")
    assert plan.blocks == 4 and plan.block_keys == KEYS and plan.nbytes == 4 * 1024
    assert plan.est_transfer_s < plan.est_recompute_s
    directive = plan.to_directive()
    assert directive["plan_id"] == plan.plan_id and planner.get(plan.plan_id) is plan
    return plan_view(plan), directive, plan.to_dict()


def _holder_not_overloaded(m):
    return make_planner(m).plan({"pod-1": prov(4.0, 4)}, {"pod-1": 1.0, "pod-2": 0.0}, KEYS)


def _no_holder(m):
    return make_planner(m).plan({"pod-1": prov(0.0, 0)}, {"pod-1": 9.0}, KEYS)


def _too_few_blocks(m):
    return make_planner(m, min_blocks=3).plan({"pod-1": prov(2.0, 2)},
                                              {"pod-1": 9.0, "pod-2": 0.0}, KEYS[:2])


def _no_target(m):
    return make_planner(m).plan({"pod-1": prov(4.0, 4)}, {"pod-1": 5.0, "pod-2": 5.0}, KEYS)


def _no_target_without_headroom(m):
    planner = make_planner(m, load_threshold=6.0)
    first = planner.plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 4.0}, KEYS)
    assert first == (None, "no-target")
    plan, outcome = planner.plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 2.0}, KEYS,
                                 now=0.0)
    assert outcome == "planned" and plan.target_pod == "pod-2"
    return first, plan_view(plan)


def _recompute_cheaper(m):
    advisor = fed_advisor(m, load_s=None, store_s=None)
    advisor.observe_load(1024, 100.0)  # absurdly slow readback
    return make_planner(m, advisor).plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0},
                                         KEYS)


def _no_block_bytes(m):
    return make_planner(m, fed_advisor(m, bytes_per_block=0)).plan(
        {"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS)


def _zero_rtt_estimator_never_plans(m):
    advisor = fed_advisor(m, load_s=None, store_s=None)
    assert advisor.rtt.estimate(4096) is None
    planner = make_planner(m, advisor)
    got = planner.plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS)
    assert planner.stats()["outcomes"] == {"no-rtt-observations": 1}
    return got


def _no_prefill_rate_still_plans_flagged(m):
    advisor = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(bytes_per_block=1024,
                                                                     block_tokens=BLOCK_SIZE))
    advisor.observe_load(4096, 0.001)
    advisor.observe_store(4096, 0.0005)
    plan, outcome = make_planner(m, advisor).plan(
        {"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS, now=0.0)
    assert outcome == "planned" and plan.reason == "no-prefill-rate"
    assert plan.est_recompute_s is None
    return plan_view(plan)


def _determinism_under_fixed_snapshot(m):
    per_pod = {"pod-b": prov(4.0, 4), "pod-a": prov(4.0, 4), "pod-c": prov(0.0, 0)}
    loads = {"pod-a": 9.0, "pod-b": 9.0, "pod-c": 0.0, "pod-d": 0.0}
    directives = []
    for _ in range(2):
        plan, outcome = make_planner(m, fed_advisor(m)).plan(
            per_pod, dict(loads), KEYS, token_ids=list(range(16)), block_size=BLOCK_SIZE,
            now=0.0)
        assert outcome == "planned"
        directives.append(plan.to_directive())
    assert directives[0] == directives[1]
    assert (directives[0]["source_pod"], directives[0]["target_pod"]) == ("pod-a", "pod-c")
    return directives[0]


def _replan_damping_in_flight(m):
    planner = make_planner(m)
    snapshot = ({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS)
    plan, outcome = planner.plan(*snapshot, now=0.0)
    assert outcome == "planned"
    outcomes = [planner.plan(*snapshot, now=0.0)[1]]
    planner.mark(plan.plan_id, m.transfer.DONE)
    outcomes.append(planner.plan(*snapshot, now=1.0)[1])
    other, outcome = planner.plan(snapshot[0], snapshot[1], [77, 88, 99, 110], now=1.0)
    outcomes.append(outcome)
    assert outcomes == ["in-flight", "recently-transferred", "planned"]
    return outcomes, planner.stats()


def _replan_cooldown_expires(m):
    planner = make_planner(m, replan_cooldown_s=5.0)
    snapshot = ({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS)
    plan, _ = planner.plan(*snapshot, now=0.0)
    planner.mark(plan.plan_id, m.transfer.DONE)
    assert planner.plan(*snapshot, now=4.0)[1] == "recently-transferred"
    again, outcome = planner.plan(*snapshot, now=5.0)
    assert outcome == "planned" and again.plan_id != plan.plan_id
    return plan_view(again)


def _ttl_expiry(m):
    planner = make_planner(m, ttl_s=10.0)
    plan, _ = planner.plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS, now=0.0)
    counts = (planner.expire(now=5.0), planner.expire(now=10.0))
    assert counts == (0, 1) and plan.state == m.transfer.EXPIRED
    return counts


def _invalidate_pod(m):
    planner = make_planner(m)
    plan, _ = planner.plan({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0, "pod-2": 0.0}, KEYS)
    counts = (planner.invalidate_pod("pod-3"), planner.invalidate_pod("pod-2"))
    assert counts == (0, 1) and plan.state == m.transfer.INVALIDATED
    return counts


def _registry_bounded(m):
    planner = make_planner(m, max_plans=3)
    for _ in range(5):
        planner.plan_warmup("pod-1", "pod-2", KEYS, now=0.0)
    stats = planner.stats()
    assert stats["plans"] == 3 and planner.get(1) is None and planner.get(5) is not None
    return stats


def _pick_tier(m):
    return [m.planner._pick_tier(tiers) for tiers in (
        None, {}, {"host": 3, "hbm": 3}, {"shared_storage": 5, "host": 2},
        {"gpu": 4, "hbm": 4}, {"gpu": 5, "cpu": 5}, {"host": 1, "shared_storage": 1})]


def _seeded_plans(m):
    """200 random scoring snapshots (holders, tiers, loads, chains that
    repeat), priced by a randomly fed advisor, planned at rising
    ``now``s with TTL sweeps, marks and pod departures in between: the
    same plans, outcomes and registry."""
    rng = np.random.default_rng(9)
    advisor = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(
        bytes_per_block=2 << 20, block_tokens=16, prefill_tokens_per_s=18000.0))
    planner = m.transfer.TransferPlanner(advisor, load_threshold=4.0, min_blocks=2,
                                         price_margin=0.1, max_plans=16, ttl_s=30.0,
                                         replan_cooldown_s=5.0)
    pods = [f"pod-{i}" for i in range(5)]
    chains = [[int(x) for x in rng.integers(1, 1 << 62, 40)] for _ in range(6)]
    tiers = ("hbm", "host", "shared_storage")
    now, out = 0.0, []
    for step in range(200):
        now += float(rng.uniform(0.0, 4.0))
        if rng.random() < 0.3:
            advisor.observe_load(int(rng.integers(1 << 20, 1 << 30)),
                                 float(rng.uniform(0.01, 2.0)))
        if rng.random() < 0.2:
            advisor.observe_store(int(rng.integers(1 << 20, 1 << 30)),
                                  float(rng.uniform(0.01, 2.0)), float(rng.uniform(0, 0.3)))
        chain = chains[int(rng.integers(len(chains)))]
        per_pod = {}
        for pod in pods:
            blocks = int(rng.integers(0, 40))
            if blocks and rng.random() < 0.6:
                per_pod[pod] = prov(float(blocks) * float(rng.choice([1.0, 0.8, 0.5])), blocks,
                                    {str(rng.choice(tiers)): blocks})
        loads = {pod: float(rng.integers(0, 9)) for pod in pods if rng.random() < 0.8}
        plan, outcome = planner.plan(per_pod, loads, chain, token_ids=list(range(640)),
                                     block_size=16, now=now)
        out.append((outcome, plan_view(plan)))
        if plan is not None and rng.random() < 0.5:
            planner.mark(plan.plan_id, str(rng.choice([m.transfer.DONE, m.transfer.EXECUTING])))
        if step % 17 == 16:
            out.append(("expired", planner.expire(now=now)))
        if step % 41 == 40:
            out.append(("gone", planner.invalidate_pod(str(rng.choice(pods)))))
    return out, planner.stats()


PLANNER_STORIES = {f.__name__[1:]: f for f in (
    _planned_happy_path, _holder_not_overloaded, _no_holder, _too_few_blocks, _no_target,
    _no_target_without_headroom, _recompute_cheaper, _no_block_bytes,
    _zero_rtt_estimator_never_plans, _no_prefill_rate_still_plans_flagged,
    _determinism_under_fixed_snapshot, _replan_damping_in_flight, _replan_cooldown_expires,
    _ttl_expiry, _invalidate_pod, _registry_bounded, _pick_tier, _seeded_plans)}
DECLINED = {"holder_not_overloaded": "holder-not-overloaded", "no_holder": "no-holder",
            "too_few_blocks": "too-few-blocks", "no_target": "no-target",
            "recompute_cheaper": "recompute-cheaper", "no_block_bytes": "no-block-bytes",
            "zero_rtt_estimator_never_plans": "no-rtt-observations"}


@pytest.mark.parametrize("story", sorted(PLANNER_STORIES))
def test_planner_matches_reference(story):
    got = same(PLANNER_STORIES[story])
    if story in DECLINED:
        assert got == (None, DECLINED[story])


# --------------------------------------------------------------- executor


def _executor_story(m, mutate, mode="copy", tier="hbm", n_blocks=8):
    """Seed pod-1's chain, plan a warm-up copy to pod-2, let ``mutate``
    change pod-1's residency, execute: (result, plan state, published
    events, executor stats, index dump, scores)."""
    indexer, pool = make_stack(m)
    try:
        tokens = list(range(1, n_blocks * BLOCK_SIZE + 1))
        hashes = [0x7000 + i for i in range(n_blocks)]
        seed_chain(m, pool, "pod-1", hashes, tokens)
        keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
        plan = make_planner(m).plan_warmup("pod-1", "pod-2", keys, engine_hashes=hashes,
                                           token_ids=tokens, block_size=BLOCK_SIZE, tier=tier,
                                           now=0.0)
        mutate(m, pool, hashes, tokens)
        recorder = Recorder(m, pool)
        executor = m.transfer.TransferExecutor(indexer.kv_block_index, recorder, MODEL)
        ok = executor.execute(plan, mode=mode)
        pool.drain()
        again = executor.execute(plan)  # a finished plan is stale
        scores = indexer.get_pod_scores(prompt_of(tokens), MODEL, ["pod-1", "pod-2"])
        return (ok, again, plan.state, recorder.events, executor.stats(),
                dump_view(indexer.kv_block_index), scores)
    finally:
        pool.shutdown()
        indexer.shutdown()


def test_executor_copy_flips_target_score():
    ok, again, state, events, _, _, scores = same(lambda m: _executor_story(
        m, lambda *a: None))
    assert ok is True and again is False and state == "done"
    assert scores == {"pod-1": 8.0, "pod-2": 8.0} and len(events) == 1


def test_executor_lands_the_chain_under_the_fleets_device_medium():
    """Pods that name their device tier ``gpu``: the executor stores the
    copy there, so the target's own later ``BlockRemoved`` takes it out."""
    m = mods("port")
    indexer, pool = make_stack(m)
    try:
        tokens = list(range(1, 8 * BLOCK_SIZE + 1))
        hashes = [0x7000 + i for i in range(8)]
        seed_chain(m, pool, "pod-1", hashes, tokens, medium="gpu")
        keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m))
        executor = engine.attach_executor(indexer.kv_block_index, pool, MODEL,
                                          start_warmup=False, device_medium="gpu")
        plan = engine.planner.plan_warmup("pod-1", "pod-2", keys, engine_hashes=hashes,
                                          token_ids=tokens, block_size=BLOCK_SIZE, tier="gpu",
                                          now=0.0)
        assert executor.execute(plan)
        pool.drain()
        prompt = prompt_of(tokens)
        assert indexer.get_pod_scores(prompt, MODEL, ["pod-2"]) == {"pod-2": 8.0}
        assert {e.device_tier for _, pods in indexer.kv_block_index.dump_entries()[0]
                for e in pods} == {"gpu"}
        publish(m, pool, "pod-2", [m.events.BlockRemoved(block_hashes=hashes, medium="gpu")])
        assert indexer.get_pod_scores(prompt, MODEL, ["pod-1", "pod-2"]) == {
            "pod-1": 8.0, "pod-2": 0.0}
    finally:
        pool.shutdown()
        indexer.shutdown()


def test_executor_source_dies_mid_plan_no_phantom_entries():
    def die(m, pool, hashes, tokens):
        publish(m, pool, "pod-1", [m.events.BlockRemoved(block_hashes=hashes, medium="hbm")])

    ok, _, state, events, stats, dump, scores = same(lambda m: _executor_story(m, die))
    assert ok is False and state == "invalidated" and stats["invalidated"] == 1
    assert events == [] and dump[0] == [] and scores == {"pod-1": 0.0, "pod-2": 0.0}


def test_executor_transfer_vs_demotion_race_uses_current_tier():
    def demote(m, pool, hashes, tokens):
        publish(m, pool, "pod-1", [
            m.events.BlockStored(block_hashes=hashes, parent_block_hash=None,
                                 token_ids=tokens, block_size=BLOCK_SIZE, medium="host"),
            m.events.BlockRemoved(block_hashes=hashes, medium="hbm")])

    ok, _, _, events, _, dump, _ = same(lambda m: _executor_story(m, demote, mode="move"))
    assert ok is True
    # The move removes the source at host, the tier it holds now.
    assert [e[1][0][1]["medium"] for e in events] == ["hbm", "host"]
    assert {pods[0] for _, pods in dump[0]} == {("pod-2", "hbm")}


def test_executor_partial_surviving_prefix():
    def evict_tail(m, pool, hashes, tokens):
        publish(m, pool, "pod-1", [m.events.BlockRemoved(block_hashes=hashes[4:], medium="hbm")])

    ok, _, _, events, _, _, scores = same(lambda m: _executor_story(m, evict_tail))
    assert ok is True and scores["pod-2"] == 4.0
    assert len(events[0][1][0][1]["block_hashes"]) == 4


# ----------------------------------------------------------------- warm-up


def test_catalog_longer_chain_wins():
    def story(m):
        catalog = m.transfer.HotFamilyCatalog(max_families=2)
        catalog.note(1, "pod-1", [11, 22, 33], now=1.0)
        catalog.note(1, "pod-2", [11], now=2.0)
        views = [dataclasses.asdict(catalog.get(1))]
        assert views[0]["block_keys"] == [11, 22, 33] and views[0]["holder_pod"] == "pod-1"
        catalog.note(1, "pod-2", [11, 22, 33, 44], now=3.0)
        assert catalog.get(1).holder_pod == "pod-2"
        catalog.note(2, "pod-1", [55], now=4.0)
        catalog.note(3, "pod-1", [66], now=5.0)
        assert catalog.stats()["families"] == 2 and catalog.get(1) is None
        return views, catalog.families(), catalog.stats()

    same(story)


def test_ledger_ranked_families():
    def story(m):
        ledger = m.ledger.CacheStatsLedger(m.ledger.LedgerConfig(sample_rate=1.0))
        ledger.record(0xA, MODEL, 4, 4, now=0.0)
        ledger.record(0xA, MODEL, 4, 4, now=10.0)
        ledger.record(0xB, MODEL, 4, 4, now=8.0)
        ledger.record(0xB, MODEL, 4, 4, now=10.0)
        catalog = m.transfer.HotFamilyCatalog()
        catalog.note(0xA, "pod-1", [1, 2])
        catalog.note(0xB, "pod-1", [3, 4])
        worker = m.transfer.WarmupWorker(catalog, make_planner(m), executor=None, ledger=ledger,
                                         warmup_families=1)
        ranked = worker._ranked_families()
        assert ranked == [0xB]
        no_ledger = m.transfer.WarmupWorker(catalog, make_planner(m), executor=None)
        return ranked, no_ledger._ranked_families()

    same(story)


def test_cold_pod_warms_through_real_events():
    def story(m):
        ledger = m.ledger.CacheStatsLedger(m.ledger.LedgerConfig(sample_rate=1.0))
        indexer, pool = make_stack(m, ledger=ledger)
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m), ledger=ledger,
                                           config=m.transfer.TransferConfig(load_threshold=2.0,
                                                                            warmup_moves=2))
        indexer.set_transfer_engine(engine)
        engine.attach_executor(indexer.kv_block_index, pool, MODEL, start_warmup=False)
        try:
            tokens = list(range(1, 17))
            seed_chain(m, pool, "pod-1", [0x8800 + i for i in range(4)], tokens)
            prompt = prompt_of(tokens)
            for _ in range(2):
                indexer.get_pod_scores_planned(prompt, MODEL, ["pod-1", "pod-2"])
            assert engine.catalog.stats()["families"] == 1
            queued = engine.register_cold_pod("pod-3")
            assert queued == 1 and engine.warmup.status()["cold_pods"] == {"pod-3": 1}
            plans = [p.to_dict() for p in engine.warmup.queued_plans()]
            moved = engine.run_warmup_cycle()
            pool.drain()
            scores = indexer.get_pod_scores(prompt, MODEL, ["pod-1", "pod-3"])
            assert moved == 1 and scores["pod-3"] == scores["pod-1"] == 4.0
            status = engine.warmup.status()
            assert status["cold_pods"] == {} and status["warmed_moves"] == {"pod-3": 1}
            status.pop("running")
            return plans, moved, scores, status, dump_view(indexer.kv_block_index)
        finally:
            engine.close()
            pool.shutdown()
            indexer.shutdown()

    same(story)


def test_register_cold_pod_skips_self_holder():
    def story(m):
        catalog = m.transfer.HotFamilyCatalog()
        catalog.note(1, "pod-1", [11, 22])
        worker = m.transfer.WarmupWorker(catalog, make_planner(m), executor=None)
        assert worker.register_cold_pod("pod-1") == 0
        return worker.status()["queued"]

    same(story)


def test_seeded_warmup_drain():
    """Twelve families with random chains, holders and rhythms, two cold
    pods, a budget of 3 moves a cycle (some sources gone before their
    turn): the same queue, drain, events, index and counts."""

    def story(m):
        rng = np.random.default_rng(13)
        ledger = m.ledger.CacheStatsLedger(m.ledger.LedgerConfig(sample_rate=1.0))
        indexer, pool = make_stack(m, ledger=ledger)
        recorder = Recorder(m, pool)
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m), ledger=ledger,
                                           config=m.transfer.TransferConfig(warmup_families=10,
                                                                            warmup_moves=3))
        engine.attach_executor(indexer.kv_block_index, recorder, MODEL, start_warmup=False)
        try:
            for family in range(12):
                n = int(rng.integers(2, 6))
                tokens = [int(x) for x in rng.integers(1, 5000, n * BLOCK_SIZE)]
                hashes = [family * 100 + i for i in range(n)]
                holder = f"pod-{int(rng.integers(0, 3))}"
                seed_chain(m, pool, holder, hashes, tokens)
                keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
                ewma = float(rng.uniform(1.0, 100.0))
                ledger.record(family, MODEL, n, n, now=200.0 - ewma)
                ledger.record(family, MODEL, n, n, now=200.0)
                engine.catalog.note(family, holder, keys, engine_hashes=hashes, token_ids=tokens,
                                    block_size=BLOCK_SIZE, now=float(family))
                if family % 5 == 4:  # this source forgets its chain before the drain
                    publish(m, pool, holder, [m.events.BlockRemoved(block_hashes=hashes,
                                                                    medium="hbm")])
            queued = [engine.register_cold_pod(pod) for pod in ("pod-7", "pod-8")]
            order = [(p.source_pod, p.target_pod, p.block_keys[0])
                     for p in engine.warmup.queued_plans()]
            moves = []
            while engine.warmup.status()["queued"]:
                moves.append(engine.run_warmup_cycle())
            pool.drain()
            status = engine.warmup.status()
            status.pop("running")
            return (queued, order, moves, status, recorder.events,
                    dump_view(indexer.kv_block_index), engine.executor.stats())
        finally:
            engine.close()
            pool.shutdown()
            indexer.shutdown()

    same(story)


# ------------------------------------------------------------ load blend


def _blend_story(m, config_kw, calls):
    indexer, pool = make_stack(m, **config_kw)
    try:
        tokens = list(range(1, 17))
        seed_chain(m, pool, "pod-1", [0x9900 + i for i in range(4)], tokens)
        return [call(indexer, prompt_of(tokens)) for call in calls]
    finally:
        pool.shutdown()
        indexer.shutdown()


def test_blend_divides_by_queue_depth():
    got = same(lambda m: _blend_story(m, dict(load_blend=0.5), [
        lambda ix, p: ix.get_pod_scores(p, MODEL, ["pod-1", "pod-2"], pod_loads={"pod-1": 2.0})]))
    assert got == [{"pod-1": 2.0, "pod-2": 0.0}]


def test_blend_parity_when_disabled():
    got = same(lambda m: _blend_story(m, dict(load_blend=0.0), [
        lambda ix, p: ix.get_pod_scores(p, MODEL, ["pod-1"]),
        lambda ix, p: ix.get_pod_scores(p, MODEL, ["pod-1"], pod_loads={"pod-1": 50.0})]))
    assert got == [{"pod-1": 4.0}] * 2


def test_explain_shows_the_blend():
    (got,) = same(lambda m: _blend_story(m, dict(load_blend=0.5), [
        lambda ix, p: ix.get_pod_scores_explained(p, MODEL, ["pod-1"],
                                                  pod_loads={"pod-1": 2.0})]))
    scores, detail = got
    assert scores == {"pod-1": 2.0}
    assert detail["load_blend"]["pods"]["pod-1"] == {"raw": 4.0, "queue_depth": 2.0,
                                                     "blended": 2.0}


@pytest.mark.parametrize("raw,want", [(None, 0.0), ("0.25", 0.25), ("bogus", 0.0)])
def test_load_blend_env_default(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("LOAD_BLEND", raising=False)
    else:
        monkeypatch.setenv("LOAD_BLEND", raw)
    assert same(lambda m: m.indexer._env_load_blend_default()) == want


@pytest.mark.parametrize("fast", [True, False], ids=["fast_lane", "straight_lane"])
def test_unknown_pod_zero_fill(fast):
    def story(m):
        def calls(ix, p):
            out = [ix.get_pod_scores(p, MODEL, ["pod-1", "ghost-pod"]) for _ in range(2)]
            scores, detail = ix.get_pod_scores_explained(p, MODEL, ["pod-1", "ghost-pod"])
            return out, scores, detail["pods"]["ghost-pod"]

        return _blend_story(m, dict(read_path_fast_lane=fast), [calls])

    ((scores, explained, ghost),) = same(story)
    assert scores == [{"pod-1": 4.0, "ghost-pod": 0.0}] * 2 and explained["ghost-pod"] == 0.0
    assert ghost == {"score": 0.0, "blocks_matched": 0, "break_index": 0, "tiers": {}}


# ------------------------------------------------------------------ engine


def test_transfer_config_from_env(monkeypatch):
    for name, value in (("TRANSFER_LOAD_THRESHOLD", "7.5"), ("TRANSFER_MIN_BLOCKS", "3"),
                        ("TRANSFER_WARMUP_MOVES", "9"), ("TRANSFER_TTL_S", "bogus"),
                        ("TRANSFER_PRICE_MARGIN", "0.2"), ("TRANSFER_MAX_PLANS", "12"),
                        ("TRANSFER_REPLAN_COOLDOWN_S", "2"), ("TRANSFER_WARMUP_FAMILIES", "4"),
                        ("TRANSFER_WARMUP_INTERVAL_S", "0.5")):
        monkeypatch.setenv(name, value)
    config = same(lambda m: dataclasses.asdict(m.transfer.TransferConfig.from_env()))
    assert (config["load_threshold"], config["min_blocks"], config["warmup_moves"],
            config["ttl_s"]) == (7.5, 3, 9, 30.0)


def test_plan_for_chain_directive_shape():
    def story(m):
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m),
                                           config=m.transfer.TransferConfig(load_threshold=2.0))
        directive = engine.plan_for_chain({"pod-1": prov(4.0, 4), "pod-2": prov(0.0, 0)},
                                          {"pod-1": 5.0, "pod-2": 0.0}, KEYS,
                                          token_ids=list(range(16)), block_size=BLOCK_SIZE)
        assert directive["planned"] is True and directive["outcome"] == "planned"
        assert (directive["source_pod"], directive["target_pod"]) == ("pod-1", "pod-2")
        declined = engine.plan_for_chain({"pod-1": prov(4.0, 4)}, {"pod-1": 0.0}, KEYS)
        assert declined == {"planned": False, "outcome": "holder-not-overloaded"}
        assert engine.catalog.stats()["families"] == 1
        status = engine.status()
        return directive, declined, status["config"], status["planner"]["outcomes"]

    same(story)


def test_plan_for_chain_never_raises_into_scoring():
    def story(m):
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m),
                                           config=m.transfer.TransferConfig())

        def boom(*args, **kwargs):
            raise RuntimeError("planner bug")

        engine.planner.plan = boom
        return engine.plan_for_chain({"pod-1": prov(4.0, 4)}, {"pod-1": 9.0}, KEYS)

    assert same(story) is None


def test_engines_share_one_advisor():
    """With tiering on, the transfer engine prices with the policy
    engine's advisor: what the offload plane feeds it moves the plans."""

    def story(m):
        policy = m.tiering.PolicyEngine(config=m.tiering.TieringConfig())
        engine = m.transfer.TransferEngine(advisor=policy.advisor,
                                           config=m.transfer.TransferConfig(load_threshold=2.0))
        assert engine.advisor is policy.advisor
        before = engine.plan_for_chain({"pod-1": prov(4.0, 4)}, {"pod-1": 5.0, "pod-2": 0.0},
                                       KEYS)
        policy.advisor.config.bytes_per_block = 1024
        policy.advisor.observe_load(4096, 0.001)
        policy.advisor.observe_prefill(16, 1.0)
        after = engine.plan_for_chain({"pod-1": prov(4.0, 4)}, {"pod-1": 5.0, "pod-2": 0.0},
                                      [5, 6, 7, 8])
        return before, after["planned"], after["est_transfer_s"], after["est_recompute_s"]

    before, planned, *_ = same(story)
    assert before == {"planned": False, "outcome": "no-block-bytes"} and planned is True


def test_planned_scoring_variant():
    def story(m):
        indexer, pool = make_stack(m)
        engine = m.transfer.TransferEngine(advisor=fed_advisor(m),
                                           config=m.transfer.TransferConfig(load_threshold=2.0))
        indexer.set_transfer_engine(engine)
        try:
            tokens = list(range(1, 17))
            seed_chain(m, pool, "pod-1", [0xBB00 + i for i in range(4)], tokens)
            scores, directive = indexer.get_pod_scores_planned(
                prompt_of(tokens), MODEL, ["pod-1", "pod-2"],
                pod_loads={"pod-1": 9.0, "pod-2": 0.0})
            assert scores["pod-1"] == 4.0 and directive["planned"] is True
            assert directive["target_pod"] == "pod-2"
            return scores, directive
        finally:
            engine.close()
            pool.shutdown()
            indexer.shutdown()

    same(story)


# ------------------------------------------------ HTTP debug surface


def _post(base, path, payload):
    import json
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as response:
        return json.load(response)


def _get(base, path):
    import json
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=10) as response:
        return json.load(response)


def _planned_scoring_over_http(m):
    indexer, pool = make_stack(m)
    engine = m.transfer.TransferEngine(advisor=fed_advisor(m),
                                       config=m.transfer.TransferConfig(load_threshold=2.0))
    indexer.set_transfer_engine(engine)
    server = m.http.serve(indexer, host="127.0.0.1", port=0, transfer=engine)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        tokens = list(range(1, 17))
        seed_chain(m, pool, "pod-1", [0xCC00 + i for i in range(4)], tokens)
        reply = _post(base, "/score_completions", {
            "prompt": prompt_of(tokens), "model": MODEL, "pods": ["pod-1", "pod-2"],
            "pod_loads": {"pod-1": 9.0, "pod-2": 0.0}, "plan": True})
        payload = _get(base, "/debug/transfer")
        health = _get(base, "/healthz")
        debug_index = _get(base, "/debug")
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        pool.shutdown()
        indexer.shutdown()
    return reply, payload, health, debug_index


@pytest.mark.parametrize("side", SIDES)
def test_debug_transfer_healthz_and_planned_scoring(side):
    """``TestTransferHttpSurface.test_debug_endpoint_healthz_and_planned_scoring``."""
    reply, payload, health, debug_index = _planned_scoring_over_http(mods(side))
    assert reply["scores"]["pod-1"] == 4.0
    assert reply["transfer"]["planned"] is True
    assert reply["transfer"]["target_pod"] == "pod-2"
    assert payload["planner"]["outcomes"]["planned"] == 1
    assert payload["catalog"]["families"] == 1
    assert payload["config"]["load_threshold"] == 2.0
    assert health["transfer"]["plans"] == 1
    surfaces = {row["path"]: row["enabled"] for row in debug_index["surfaces"]}
    assert surfaces["/debug/transfer"] is True


def test_planned_scoring_over_http_is_the_same_on_both_packages():
    """The scores, the directive (its timing-free fields), the planner's
    outcomes and config, and the ``/debug`` surface list are equal."""

    def view(m):
        reply, payload, health, debug_index = _planned_scoring_over_http(m)
        directive = {k: v for k, v in reply["transfer"].items() if not k.endswith("_s")}
        return (reply["scores"], directive, payload["planner"]["outcomes"], payload["config"],
                health["transfer"]["plans"],
                sorted((row["path"], row["enabled"]) for row in debug_index["surfaces"]))

    same(view)


@pytest.mark.parametrize("side", SIDES)
def test_debug_transfer_404_when_disabled(side):
    """``TestTransferHttpSurface.test_debug_endpoint_404_when_disabled``."""
    import urllib.error

    m = mods(side)
    indexer, pool = make_stack(m)
    server = m.http.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base, "/debug/transfer")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        pool.shutdown()
        indexer.shutdown()


@pytest.mark.parametrize("side", SIDES)
def test_malformed_pod_loads_rejected(side):
    """``TestTransferHttpSurface.test_malformed_pod_loads_rejected``."""
    import urllib.error

    m = mods(side)
    indexer, pool = make_stack(m)
    server = m.http.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/score_completions",
                  {"prompt": "t1 t2", "model": MODEL, "pod_loads": {"pod-1": "busy"}})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        pool.shutdown()
        indexer.shutdown()
