"""The port's index auditor against the JAX package's, on the CPU: the
auditor cases of ``tests/test_cache_analytics.py`` run through both
packages give equal ``AuditReport.to_dict()`` (timestamps and durations
left out) and equal status and logs."""

import random

import pytest

from llm_d_kv_cache_manager_tpu.analytics import auditor as ref_auditor
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import (
    ChunkedTokenDatabase as RefTokenDB,
    TokenProcessorConfig as RefTokenConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex as RefIndex
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.index import PodEntry as RefPodEntry
from llm_d_kv_cache_manager_tpu.kvevents import resync as ref_resync
from tests.helpers.torch_port import port

MODEL = "m"
BLOCK = 4


class Side:
    """One package's auditor, index, token processor and inventory types."""

    def __init__(self, name: str) -> None:
        if name == "ref":
            self.auditor, self.resync = ref_auditor, ref_resync
            self.index = RefIndex()
            self.db = RefTokenDB(RefTokenConfig(block_size=BLOCK))
            self.entry = RefPodEntry
        else:
            self.auditor, self.resync = port("analytics.auditor"), port("kvevents.resync")
            self.index = port("kvcache.kvblock.in_memory").InMemoryIndex()
            tp = port("kvcache.kvblock.token_processor")
            self.db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=BLOCK))
            self.entry = port("kvcache.kvblock.index").PodEntry

    def make(self, fetch, **config):
        return self.auditor.IndexAuditor(
            self.index, self.db, self.resync.CallableInventorySource(fetch),
            self.auditor.AuditorConfig(interval_s=0.0, **config))


class SyntheticPod:
    """One pod's index entries and a matching inventory (engine hashes
    that differ from the request keys)."""

    def __init__(self, side: Side, pod: str, n_blocks: int, tier="hbm", seed=0):
        rng = random.Random(seed)
        self.side, self.pod, self.tier = side, pod, tier
        self.tokens = [rng.randrange(1, 1000) for _ in range(n_blocks * BLOCK)]
        self.request_keys = side.db.tokens_to_kv_block_keys(0, self.tokens, MODEL)
        self.engine_hashes = [k ^ 0xDEAD for k in self.request_keys]
        side.index.add(self.engine_hashes, self.request_keys, [side.entry(pod, tier)])

    def inventory(self, drop_last=0, tier=None):
        keep = len(self.engine_hashes) - drop_last
        r = self.side.resync
        return r.PodInventory(self.pod, MODEL, [r.InventoryBlock(
            block_hashes=self.engine_hashes[:keep], token_ids=self.tokens[:keep * BLOCK],
            block_size=BLOCK, medium=tier or self.tier)])


def _report(report) -> dict:
    out = report.to_dict()
    del out["ts_unix"], out["duration_ms"]
    return out


def _status(auditor) -> dict:
    out = auditor.status()
    del out["last_cycle_unix"]
    return out


def case_clean(side):
    pod = SyntheticPod(side, "p0", 20)
    return [_report(side.make(lambda p: pod.inventory()).audit_pod("p0"))]


def case_phantom(side):
    pod = SyntheticPod(side, "p0", 40)
    return [_report(side.make(lambda p: pod.inventory(drop_last=4)).audit_pod("p0"))]


def case_missing(side):
    pod = SyntheticPod(side, "p0", 30)
    side.index.purge_pod("p0")
    side.index.add(pod.engine_hashes[:24], pod.request_keys[:24], [side.entry("p0", "hbm")])
    return [_report(side.make(lambda p: pod.inventory()).audit_pod("p0"))]


def case_wrong_tier(side):
    pod = SyntheticPod(side, "p0", 10, tier="hbm")
    return [_report(side.make(lambda p: pod.inventory(tier="host")).audit_pod("p0"))]


def case_parent_chains(side):
    rng = random.Random(7)
    tokens = [rng.randrange(1, 1000) for _ in range(BLOCK * 12)]
    keys = side.db.tokens_to_kv_block_keys(0, tokens, MODEL)
    engine = [k ^ 0xBEEF for k in keys]
    side.index.add(engine, keys, [side.entry("p0", "hbm")])
    r, split = side.resync, 5
    blocks = [r.InventoryBlock(engine[:split], tokens[:split * BLOCK], BLOCK, medium="hbm"),
              r.InventoryBlock(engine[split:], tokens[split * BLOCK:], BLOCK,
                               parent_block_hash=engine[split - 1], medium="hbm"),
              r.InventoryBlock([0xABC], [1] * BLOCK, BLOCK, parent_block_hash=0x999),
              r.InventoryBlock(["bad"], [1] * BLOCK, BLOCK)]
    auditor = side.make(lambda p: r.PodInventory(p, MODEL, blocks))
    return [_report(auditor.audit_pod("p0"))]


def case_failed_fetch(side):
    SyntheticPod(side, "p0", 5)
    auditor = side.make(lambda p: None)
    report = _report(auditor.audit_pod("p0"))

    def raising(p):
        raise OSError("inventory endpoint down")

    return [report, _report(side.make(raising).audit_pod("p0")), _status(auditor)]


def case_run_cycle(side):
    p0, p1 = SyntheticPod(side, "p0", 10, seed=1), SyntheticPod(side, "p1", 10, seed=2)
    inventories = {"p0": lambda: p0.inventory(), "p1": lambda: p1.inventory(drop_last=2)}
    auditor = side.make(lambda p: inventories[p]())
    reports = [_report(r) for r in auditor.run_cycle()]
    logs = [[{k: v for k, v in r.items() if k not in ("ts_unix", "duration_ms")}
             for r in rows] for rows in (auditor.divergent(), auditor.recent())]
    return reports + [_status(auditor)] + logs


def case_round_robin(side):
    for i in range(4):
        SyntheticPod(side, f"p{i}", 4, seed=i)
    auditor = side.make(lambda p: None, pods_per_cycle=2)
    seen = [[_report(r) for r in auditor.run_cycle()] for _ in range(3)]
    return seen + [_status(auditor)]


def case_log_bounded(side):
    pod = SyntheticPod(side, "p0", 4)
    auditor = side.make(lambda p: pod.inventory(), log_keep=5)
    for _ in range(20):
        auditor.audit_pod("p0")
    return [len(auditor.recent(100)), _status(auditor)]


def case_prunes_departed(side):
    pod = SyntheticPod(side, "p0", 10)
    auditor = side.make(lambda p: pod.inventory(drop_last=2))
    first = [_report(r) for r in auditor.run_cycle()] + [_status(auditor)]
    side.index.purge_pod("p0")
    return first + [auditor.run_cycle(), _status(auditor)]


def case_multi_tier(side):
    pod = SyntheticPod(side, "p0", 6, tier="hbm")
    r = side.resync
    out = []
    for order in (["hbm", "host"], ["host", "hbm"]):
        blocks = [r.InventoryBlock(list(pod.engine_hashes), list(pod.tokens), BLOCK, medium=t)
                  for t in order]
        out.append(_report(side.make(lambda p, b=blocks: r.PodInventory(p, MODEL, b))
                           .audit_pod("p0")))
    return out


CASES = [case_clean, case_phantom, case_missing, case_wrong_tier, case_parent_chains,
         case_failed_fetch, case_run_cycle, case_round_robin, case_log_bounded,
         case_prunes_departed, case_multi_tier]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_audit_reports_are_the_references(case):
    want = case(Side("ref"))
    got = case(Side("port"))
    assert got == want


def test_the_cases_find_what_the_reference_tests_assert():
    """The divergences the reference's tests pin, read off the port."""
    side = Side("port")
    assert case_phantom(side)[0]["phantom"] == 4
    assert case_missing(Side("port"))[0]["missing"] == 6
    assert case_wrong_tier(Side("port"))[0]["divergence_ratio"] == 1.0
    chains = case_parent_chains(Side("port"))[0]
    assert (chains["phantom"], chains["missing"], chains["unresolvable"]) == (0, 0, 2)
    assert case_run_cycle(Side("port"))[2]["divergent_pods"] == {"p1": 0.2}
    assert all(r["outcome"] == "clean" for r in case_multi_tier(Side("port")))


def test_auditor_config_reads_audit_interval(monkeypatch):
    config = port("analytics.auditor").AuditorConfig
    monkeypatch.setenv("AUDIT_INTERVAL_S", "2.5")
    assert config.from_env().interval_s == 2.5
    monkeypatch.setenv("AUDIT_INTERVAL_S", "soon")
    assert config.from_env().interval_s == ref_auditor.AuditorConfig.from_env().interval_s == 0.0


def test_background_worker_runs_cycles():
    import time

    side = Side("port")
    pod = SyntheticPod(side, "p0", 4)
    auditor = side.auditor.IndexAuditor(side.index, side.db,
                                        side.resync.CallableInventorySource(
                                            lambda p: pod.inventory()),
                                        side.auditor.AuditorConfig(interval_s=0.02))
    auditor.start()
    try:
        deadline = time.monotonic() + 5
        while auditor.status()["cycles"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert auditor.status()["cycles"] >= 2 and auditor.status()["running"]
    finally:
        auditor.close()
    assert not auditor.status()["running"]
