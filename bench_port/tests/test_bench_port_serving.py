"""The serving loop and its checks, on the CPU at a tiny size, through the
port's CPU paths (called directly, not through ``main``): a sound run
comes out correct, and each fault a serving cell can have, planted under
the timed path, comes out not correct."""

import json

import pytest
import torch

from bench_port import run as bench_run
from bench_port import serve, spec

TINY = {"model_id": "tiny", "family": "llama", "hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "torch_dtype": "bfloat16"}
GAP_LIMIT = 0.1  # the tiny model's own limit: its sound runs read under 0.02
CPU = torch.device("cpu")


def tiny_cell(kind: str) -> spec.Cell:
    if kind == "open":
        mix = spec.load_traffic("shared-prefix")
        mix.update(rate_per_s=16.0, pods=2, pool_tokens=4096,
                   prompt={"shared_prefix": {"groups": 4, "tokens": [32, 64], "zipf_s": 1.0,
                                             "warm_groups": 2},
                           "unique_tokens": [16, 32]},
                   output_tokens=[4, 12], decode_buckets=[1, 2, 4, 8, 16, 32])
    else:
        mix = spec.load_traffic("long-decode")
        mix.update(streams=3, requests_per_stream=3, pool_tokens=2048, max_context=128,
                   prompt={"unique_tokens": [16, 32]}, output_tokens=[16, 48],
                   decode_buckets=[3])
    mix["check"] = {"served_logit_gap": GAP_LIMIT, "tokens": 48, "max_requests": 12}
    return spec.Cell(f"tiny.{kind}", "tiny", TINY, kind, mix, 1, [], [], spec.family_of(TINY))


def served(cell, seed=2**31 + 99):
    run = bench_run.serve_cell(cell, seed, 0.75, False, CPU)
    return run, bench_run.checks(run, CPU)


def correct(compared) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


@pytest.mark.parametrize("kind", ["open", "closed"])
def test_a_sound_run_is_correct(kind):
    run, compared = served(tiny_cell(kind))
    assert correct(compared), compared
    values = bench_run.end_to_end(run)
    assert values["itl_p95_ms"] > 0 and values["output_tokens_per_s"] > 0
    if kind == "open":
        assert values["ttft_p95_ms"] >= values["ttft_p50_ms"] > 0
        assert all(lv.done for lv in run.win.lives)
        rec = bench_run.record(run)
        assert spec.metric_reader("prefix_hit_share").read(rec) > 0
        assert spec.metric_reader("route_ms_p50").read(rec) > 0
        assert spec.metric_reader("event_apply_ms").read(rec) > 0
        assert spec.metric_reader("ttft_p50_ms.traced").read(rec) == pytest.approx(values["ttft_p50_ms"])
        # No CUDA events, no trace on the CPU: the device metrics read nothing.
        for name in ("prefill_mfu", "flash_prefill_roofline", "device_idle_share.tpot"):
            assert spec.metric_reader(name).read(rec) is None
        # Every router call was judged, and the scores saw cached prefixes.
        assert any(max(s.values()) > 0 for s in run.router_scores)
    else:
        assert len(run.win.carried) == 3 and all(lv.tokens for lv in run.win.carried)


def _altered_token(monkeypatch, row=0):
    """A served token altered where it is produced: one decode row's
    logits favour another token (``row``: -1 for the last live row)."""
    real = serve.Server.decode

    def decode(self):
        step = self.steps[next(b for b in self.buckets if b >= len(self.running))]
        call = type(step).__call__

        live = len(self.running)

        def bent(obj, *a):
            out = call(obj, *a).clone()
            r = row % live
            out[r, (out[r].argmax() + 1) % out.shape[-1]] = out[r].max() + 1.0
            return out

        monkeypatch.setattr(type(step), "__call__", bent)
        try:
            return real(self)
        finally:
            monkeypatch.setattr(type(step), "__call__", call)

    monkeypatch.setattr(serve.Server, "decode", decode)


def _state_unchanged(monkeypatch):
    """A decode step that returns the pool unchanged: the new token's K/V
    is never written."""
    llama = serve.port("models.llama")
    real = llama.decode_step

    def step(params, tokens, kv_pool, *rest):
        keep = kv_pool.clone()
        out = real(params, tokens, kv_pool, *rest)
        kv_pool.copy_(keep)
        return out

    monkeypatch.setattr(llama, "decode_step", step)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the rows gets the
    first half's logits."""
    llama = serve.port("models.llama")
    real = llama.decode_step

    def step(params, tokens, *rest):
        logits, pool = real(params, tokens, *rest)
        half = (logits.shape[0] + 1) // 2
        logits = logits.clone()
        logits[half:] = logits[: logits.shape[0] - half]
        return logits, pool

    monkeypatch.setattr(llama, "decode_step", step)


def _score_altered(monkeypatch):
    """A router answer altered where it is produced: the best pod's score
    one block higher."""
    indexer = serve.port("kvcache.indexer").Indexer
    real = indexer.get_pod_scores

    def scores(self, *a, **k):
        out = dict(real(self, *a, **k))
        if out:
            best = max(out, key=out.get)
            out[best] += 1.0
        return out

    monkeypatch.setattr(indexer, "get_pod_scores", scores)


def _frames_dropped(monkeypatch):
    """Every other KV-event frame lost on its way into the index."""
    pool = serve.port("kvevents.pool").Pool
    real = pool.add_tasks
    count = {"n": 0}

    def add(self, messages):
        count["n"] += 1
        if count["n"] % 2:
            real(self, messages)

    monkeypatch.setattr(pool, "add_tasks", add)


FAULTS = {"token altered": (_altered_token, "served_logit_gap"),
          "token altered in the last row": (lambda mp: _altered_token(mp, row=-1),
                                            "served_logit_gap"),
          "state unchanged": (_state_unchanged, "served_logit_gap"),
          "half the batch": (_half_batch, "served_logit_gap"),
          "score altered": (_score_altered, "router_score_mismatches"),
          "frames dropped": (_frames_dropped, "events_dropped")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    _, compared = served(tiny_cell("open"))
    assert not correct(compared)
    assert compared[number]["value"] > compared[number]["limit"], compared


def test_the_float8_control_is_not_correct():
    """The reference computed in float8 in the program's place reads a gap
    past the limit that the program's sound runs stay under."""
    from bench_port import check

    run, compared = served(tiny_cell("open"))
    picked = check.sample(bench_run.judged(run), run.seed, 48, 12, bench_run.busiest_rows(run))
    control = check.control_gap(run.cell.family, run.params, run.cell.config, picked, CPU)
    assert compared["served_logit_gap"]["value"] < GAP_LIMIT < control["gap"], (
        compared["served_logit_gap"], control)


def test_main_refuses_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "c", "config": "x", "traffic": "shared-prefix", "chips": 1}],
        "configs": [{"name": "x", "file": "x.json"}], "end_to_end": [], "per_layer": []}))
    (tmp_path / "x.json").write_text(json.dumps(TINY))
    assert bench_run.main(["--workload", "c", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_settled_scores_are_part_of_the_check():
    run, _ = served(tiny_cell("open"))
    n = min(bench_run.SETTLED_CALLS, len(run.router_calls) // 2)
    settled = run.router_calls[-n:]
    assert n > 0 and all(lo == hi for _, bracket in settled for lo, hi in bracket.values())
    assert all(len(f) > 0 for f in run.frames.values())  # misses spread over the pods
