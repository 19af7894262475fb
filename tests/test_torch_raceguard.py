"""The port's guarded-by runtime enforcement (``utils/raceguard.py``), its
manifest and its preemption fuzzer (``hack/racefuzz_torch.py``), beside
the JAX package's.

Every case of the reference's ``tests/test_raceguard.py`` on guarded
attributes runs on both packages (``rg`` is either one's raceguard and
lockorder).  The port's own manifest (``utils/raceguard_manifest.json``)
loads by default, names the port's classes and equals what
``python -m hack.kvlint llm_d_kv_cache_manager_tpu_torch --emit-manifest``
writes for the port's sources now (a stale manifest fails here); a key
of the JAX package is refused before anything is imported; the package
arms from ``KVTPU_RACEGUARD=1``; and ``racefuzz_torch`` reproduces the
three planted defects and runs a storm clean.
"""

import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest

from llm_d_kv_cache_manager_tpu.utils import lockorder as ref_lockorder
from llm_d_kv_cache_manager_tpu.utils import raceguard as ref_raceguard
from tests.helpers.torch_port import PACKAGE, port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, PACKAGE, "utils", "raceguard_manifest.json")
SIDES = ("ref", "port")


def _side(name):
    if name == "ref":
        return SimpleNamespace(side=name, raceguard=ref_raceguard, lockorder=ref_lockorder)
    return SimpleNamespace(side=name, raceguard=port("utils.raceguard"),
                           lockorder=port("utils.lockorder"))


@pytest.fixture(params=SIDES)
def rg(request):
    """One package's raceguard with guard recording on; everything that
    the test instrumented is restored after."""
    ns = _side(request.param)
    previous = ns.lockorder.set_guard_recording(True)
    try:
        yield ns
    finally:
        ns.raceguard.uninstall()
        ns.lockorder.set_guard_recording(previous)
        ns.lockorder.set_fuzz_hook(None)


def make_cache():
    class Cache:
        def __init__(self):
            self._lock = threading.Lock()
            self._data = {}  # guarded-by: _lock

        def put(self, key, value):
            with self._lock:
                self._data[key] = value

        def get(self, key):
            with self._lock:
                return self._data.get(key)

        def bad_put(self, key, value):
            self._data[key] = value  # planted: no lock

    return Cache


class TestGuardedAttribute:
    def test_locked_access_passes_and_round_trips(self, rg):
        Cache = rg.raceguard.guard_class(make_cache(), {"_data": "_lock"})
        cache = Cache()
        cache.put("a", 1)
        assert cache.get("a") == 1

    def test_planted_unguarded_write_caught(self, rg):
        Cache = rg.raceguard.guard_class(make_cache(), {"_data": "_lock"})
        cache = Cache()
        with pytest.raises(rg.raceguard.RaceGuardViolation) as excinfo:
            cache.bad_put("a", 1)
        message = str(excinfo.value)
        assert "Cache._data" in message
        assert "_lock" in message

    def test_planted_unguarded_read_caught(self, rg):
        Cache = rg.raceguard.guard_class(make_cache(), {"_data": "_lock"})
        cache = Cache()
        with pytest.raises(rg.raceguard.RaceGuardViolation):
            cache._data

    def test_caller_locked_false_claim_caught(self, rg):
        class Ledger:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: _lock

            def _push_locked(self, item):  # kvlint: caller-locked
                self._items.append(item)

            def honest(self, item):
                with self._lock:
                    self._push_locked(item)

            def lying(self, item):
                self._push_locked(item)

        rg.raceguard.guard_class(Ledger, {"_items": "_lock"})
        ledger = Ledger()
        ledger.honest(1)
        with pytest.raises(rg.raceguard.RaceGuardViolation):
            ledger.lying(2)

    def test_violation_reports_both_thread_stacks(self, rg):
        Cache = rg.raceguard.guard_class(make_cache(), {"_data": "_lock"})
        cache = Cache()
        holder_in = threading.Event()
        release = threading.Event()

        def hold_forever():
            with cache._lock:
                holder_in.set()
                release.wait(5.0)

        holder = threading.Thread(target=hold_forever, name="holder")
        holder.start()
        try:
            assert holder_in.wait(5.0)
            with pytest.raises(rg.raceguard.RaceGuardViolation) as excinfo:
                cache._data
            message = str(excinfo.value)
            assert "accessing thread" in message
            assert "holder" in message
            assert "hold_forever" in message
        finally:
            release.set()
            holder.join()

    def test_works_with_slots(self, rg):
        class Slotted:
            __slots__ = ("_lock", "_value")

            def __init__(self):
                self._lock = threading.Lock()
                self._value = 0  # guarded-by: _lock

            def bump(self):
                with self._lock:
                    self._value += 1

        rg.raceguard.guard_class(Slotted, {"_value": "_lock"})
        obj = Slotted()
        obj.bump()
        with obj._lock:
            assert obj._value == 1
        with pytest.raises(rg.raceguard.RaceGuardViolation):
            obj._value

    def test_uninstall_restores_raw_access(self, rg):
        Cache = rg.raceguard.guard_class(make_cache(), {"_data": "_lock"})
        assert isinstance(Cache.__dict__["_data"], rg.raceguard.GuardedAttribute)
        rg.raceguard.uninstall()
        assert "_data" not in Cache.__dict__
        cache = Cache()
        cache._data["a"] = 1
        assert cache._data == {"a": 1}

    def test_composes_with_watchdog_wrapper(self, rg):
        lockorder = rg.lockorder

        class Tracked:
            def __init__(self):
                self._lock = lockorder.TrackedLock(threading.Lock(), "test.Tracked._lock", None)
                self._value = 0  # guarded-by: _lock

            def bump(self):
                with self._lock:
                    self._value += 1

        rg.raceguard.guard_class(Tracked, {"_value": "_lock"})
        obj = Tracked()
        assert isinstance(obj._lock, lockorder.TrackedLock)
        obj.bump()
        with pytest.raises(rg.raceguard.RaceGuardViolation):
            obj._value


class TestZeroCostUnarmed:
    pytestmark = pytest.mark.skipif(
        port("utils.raceguard").armed_from_env(),
        reason="suite running with KVTPU_RACEGUARD armed",
    )

    def test_nothing_installed_by_default(self):
        assert not port("utils.raceguard").installed()

    def test_manifest_class_keeps_raw_attributes(self):
        TTLCache = port("utils.ttl_cache").TTLCache
        assert "_entries" not in TTLCache.__dict__
        assert not getattr(TTLCache.__init__, "__raceguard_wrapped__", False)
        cache = TTLCache(ttl_seconds=5.0)
        assert cache._entries == {}
        assert not isinstance(cache._lock, port("utils.lockorder").GuardRecordingLock)


TTL_KEY = f"{PACKAGE}.utils.ttl_cache:TTLCache"


class TestManifestInstall:
    def test_install_uninstall_roundtrip(self, tmp_path):
        raceguard, lockorder = port("utils.raceguard"), port("utils.lockorder")
        manifest = {"version": 1, "classes": {TTL_KEY: {
            "guarded": {"_entries": "_lock"}, "locks": ["_lock", "_cb_lock"],
            "caller_locked": []}}}
        path = tmp_path / "manifest.json"
        path.write_text(json.dumps(manifest))
        TTLCache = port("utils.ttl_cache").TTLCache
        previous = lockorder.set_guard_recording(True)
        try:
            assert raceguard.install(str(path)) == 1
            assert isinstance(TTLCache.__dict__["_entries"], raceguard.GuardedAttribute)
            cache = TTLCache(ttl_seconds=5.0)
            assert isinstance(cache._lock, lockorder.GuardRecordingLock)
            cache.set("k", "v")
            assert cache.get("k") == "v"
            with pytest.raises(raceguard.RaceGuardViolation):
                cache._entries
        finally:
            raceguard.uninstall()
            lockorder.set_guard_recording(previous)
        assert "_entries" not in TTLCache.__dict__
        assert TTLCache(ttl_seconds=5.0)._entries == {}

    def test_checked_in_manifest_loads_and_names_the_ports_classes(self):
        raceguard = port("utils.raceguard")
        manifest = raceguard.load_manifest()
        assert os.path.samefile(raceguard._default_manifest_path(), MANIFEST)
        assert manifest["version"] == 1
        classes = manifest["classes"]
        assert len(classes) >= 30
        assert all(key.startswith(PACKAGE + ".") for key in classes)
        assert classes[TTL_KEY]["guarded"] == {"_entries": "_lock"}
        assert f"{PACKAGE}.offload.vllm_spec:CompletionRouter" in classes
        # The reference's manifest names the same classes of its own package.
        with open(os.path.join(REPO, "hack", "kvlint", "raceguard_manifest.json")) as handle:
            reference = json.load(handle)["classes"]
        ours = {k.replace(PACKAGE + ".", "", 1) for k in classes}
        assert {k.replace("llm_d_kv_cache_manager_tpu.", "", 1) for k in reference} <= ours

    def test_manifest_is_what_kvlint_emits_for_the_ports_sources(self, tmp_path):
        out = tmp_path / "manifest.json"
        proc = subprocess.run(
            [sys.executable, "-m", "hack.kvlint", PACKAGE, "--emit-manifest", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with open(MANIFEST) as handle:
            checked_in = json.load(handle)
        assert json.loads(out.read_text()) == checked_in, (
            "the port's raceguard manifest is stale: regenerate it with "
            f"python -m hack.kvlint {PACKAGE} --emit-manifest {PACKAGE}/utils/"
            "raceguard_manifest.json")

    def test_reference_manifest_is_refused_before_any_import(self):
        """Pointed at the JAX package's manifest, the port's install
        refuses it and imports nothing of that package (in a fresh
        interpreter, so nothing else has loaded it)."""
        script = f"""
import json, sys
sys.path.insert(0, {REPO!r})
from {PACKAGE}.utils import raceguard
try:
    raceguard.install({os.path.join(REPO, "hack", "kvlint", "raceguard_manifest.json")!r})
except ValueError as exc:
    refused = str(exc)
else:
    refused = None
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "llm_d_kv_cache_manager_tpu")
print(json.dumps({{"refused": refused, "installed": raceguard.installed(), "loaded": loaded}}))
"""
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env.pop("KVTPU_RACEGUARD", None)
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              timeout=120, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["refused"] and "outside" in result["refused"]
        assert result["installed"] is False and result["loaded"] == []

    def test_package_arms_from_the_environment_and_scores_clean(self):
        """``KVTPU_RACEGUARD=1``: importing the port installs every class
        of its manifest, and an Indexer scoring from several threads over
        an event-fed index (guarded index, pool, prefix store, ledger)
        raises no violation."""
        script = f"""
import json, sys, threading
sys.path.insert(0, {REPO!r})
import {PACKAGE}
from {PACKAGE}.utils import raceguard
from {PACKAGE}.kvcache import indexer as im
from {PACKAGE}.kvcache.kvblock import token_processor as tp
from {PACKAGE}.kvevents import events, pool as pool_mod
from {PACKAGE}.tokenization import tokenizers

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

indexer = im.Indexer(im.IndexerConfig(
    token_processor_config=tp.TokenProcessorConfig(block_size=4)), tokenizer=Words())
indexer.run()
pool = pool_mod.Pool(indexer.kv_block_index, indexer.token_processor, pool_mod.PoolConfig())
pool.start()
tokens = list(range(1, 41))
pool.add_task(pool_mod.Message(topic="kv@pod-a@m", payload=events.EventBatch(
    ts=0.0, events=[events.BlockStored(block_hashes=list(range(100, 110)),
                                       parent_block_hash=None, token_ids=tokens,
                                       block_size=4, medium="hbm")]).encode(),
    pod_identifier="pod-a", model_name="m", seq=1))
pool.drain()
prompt = " ".join(f"t{{t}}" for t in tokens)
scores, errors = [], []
def score():
    try:
        for _ in range(20):
            scores.append(indexer.get_pod_scores(prompt, "m"))
    except Exception as exc:
        errors.append(repr(exc))
threads = [threading.Thread(target=score) for _ in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
pool.shutdown()
indexer.shutdown()
print(json.dumps({{"installed": len(raceguard._instrumented), "errors": errors,
                  "scores": sorted({{json.dumps(s) for s in scores}})}}))
"""
        env = dict(os.environ, KVTPU_RACEGUARD="1")
        env.pop("PYTHONPATH", None)
        env.pop("KVTPU_RACEGUARD_MANIFEST", None)
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              timeout=120, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-4000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(MANIFEST) as handle:
            assert result["installed"] == len(json.load(handle)["classes"])
        assert result["errors"] == []
        assert result["scores"] == [json.dumps({"pod-a": 10.0})]


def run_racefuzz(*args):
    env = dict(os.environ)
    env.pop("KVTPU_RACEGUARD_MANIFEST", None)
    return subprocess.run(
        [sys.executable, "-m", "hack.racefuzz_torch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


class TestRaceFuzz:
    def test_pinned_seed_reproduces_check_then_act(self):
        proc = run_racefuzz("--plant", "check-then-act", "--seed", "1337")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "REPRODUCED" in proc.stdout
        assert "lost update" in proc.stdout
        assert proc.stdout.count("thread ") >= 2
        assert "buggy_increment" in proc.stdout

    def test_planted_guarded_write_flagged(self):
        proc = run_racefuzz("--plant", "guarded-write", "--seed", "1")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "REPRODUCED" in proc.stdout
        assert "PlantedGuardedWrite._value" in proc.stdout

    def test_planted_caller_locked_lie_flagged(self):
        proc = run_racefuzz("--plant", "caller-locked", "--seed", "1")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "REPRODUCED" in proc.stdout
        assert "PlantedCallerLocked._items" in proc.stdout

    def test_storm_runs_clean_under_the_ports_raceguard(self):
        """Storm mode over two of the port's storms with the whole port
        manifest installed, a pinned seed and microsecond preemption."""
        proc = run_racefuzz(
            "--seed", "7", "--storms", "tests/test_torch_concurrency.py::TestBackendStorm",
            "tests/test_torch_concurrency.py::TestScoreMemoStorm")
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
        assert "failed=0" in proc.stdout
