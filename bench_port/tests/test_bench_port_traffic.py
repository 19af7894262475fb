"""Traffic made from the seed: reproducible, the same work for every seed,
and the lengths, popularity and arrivals each mix states; a mix and a
metric found by name, with no code edited."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import spec
from bench_port.traffic.kinds import closed as closed_kind
from bench_port.traffic.kinds import open as open_kind
from bench_port.traffic.plan import lognormal_set, strata

SHARED = spec.load_traffic("shared-prefix")
REORDERED = dict(SHARED, reorder_block=8)  # the generator's reordering, on the same mix
LONG_DECODE = spec.load_traffic("long-decode")
BIG_SEED = 2**31 + 12345
UNIFORM = dict(SHARED, prompt={"unique_tokens": [256, 4096]}, output_tokens=[64, 256])


def test_same_seed_same_requests_and_other_seed_same_work_in_another_order():
    a = open_kind.generate(REORDERED, BIG_SEED, 30, 32768)
    b = open_kind.generate(REORDERED, BIG_SEED, 30, 32768)
    c = open_kind.generate(REORDERED, BIG_SEED + 1, 30, 32768)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a.window, b.window))
    assert [r.arrival for r in a.window] == [r.arrival for r in b.window]
    # Another seed: other token ids and another schedule ...
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a.window, c.window))
    for f in (lambda r: r.arrival, lambda r: r.output, lambda r: r.group):
        assert list(map(f, a.window)) != list(map(f, c.window))
    # ... of the same work: the same gaps, lengths and group sizes.
    n = len(a.window)
    quantiles = -np.log1p(-(np.arange(n) + 0.5) / n) / SHARED["rate_per_s"]
    for plan in (a, c):
        gaps = np.diff([r.arrival for r in plan.window])
        assert np.isin(np.round(gaps, 9), np.round(quantiles, 9)).all()
    for f in (lambda r: r.output, lambda r: r.group):
        assert sorted(map(f, a.window)) == sorted(map(f, c.window))
    assert sum(len(r.prompt) for r in a.window) == sum(len(r.prompt) for r in c.window)
    assert [len(r.prompt) for r in a.setup] == [len(r.prompt) for r in c.setup]
    # Requests of one group share its prefix, in every seed.
    first = {}
    for r in c.window:
        first.setdefault(r.group, r)
    lo = SHARED["prompt"]["shared_prefix"]["tokens"]["range"][0]
    assert all(np.array_equal(r.prompt[:lo], first[r.group].prompt[:lo]) for r in c.window)


def test_each_stretch_of_the_window_holds_the_same_work_in_every_seed():
    block = REORDERED["reorder_block"]
    a = open_kind.generate(REORDERED, BIG_SEED, 51, 32768)
    c = open_kind.generate(REORDERED, BIG_SEED + 3, 51, 32768)
    for start in range(0, len(a.window), block):
        part = [p.window[start:start + block] for p in (a, c)]
        for f in (lambda r: r.output, lambda r: r.group):
            assert sorted(map(f, part[0])) == sorted(map(f, part[1]))
        assert part[0][-1].arrival + 1e-9 >= part[1][0].arrival  # the stretches line up
    whole = dict(SHARED, reorder_block=len(a.window))
    w = open_kind.generate(whole, BIG_SEED, 51, 32768)
    assert sorted(r.group for r in w.window[:block]) != sorted(r.group for r in a.window[:block])


def test_the_shared_prefix_mix_gives_every_seed_one_schedule_and_its_own_tokens():
    a = open_kind.generate(SHARED, BIG_SEED, 51, 32768)
    c = open_kind.generate(SHARED, BIG_SEED + 5, 51, 32768)
    for f in (lambda r: r.arrival, lambda r: r.output, lambda r: r.group, lambda r: len(r.prompt)):
        assert list(map(f, a.window)) == list(map(f, c.window))
    assert [len(r.prompt) for r in a.setup] == [len(r.prompt) for r in c.setup]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a.window, c.window))


def test_open_loop_arrivals_are_poisson():
    seconds = 51
    plan = open_kind.generate(SHARED, 7, seconds, 32768)
    n = round(SHARED["rate_per_s"] * seconds)
    assert len(plan.window) == n
    arrivals = np.array([r.arrival for r in plan.window])
    assert arrivals.min() == 0 and arrivals.max() < seconds
    # Exponential gaps: mean 1 / rate, and their coefficient of variation near 1.
    gaps = np.diff(np.sort(arrivals))
    assert gaps.mean() == pytest.approx(1 / SHARED["rate_per_s"], rel=0.1)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.25)
    for r in plan.window + plan.setup:
        assert len(r.prompt) % SHARED["multiple"] == 0 and r.prompt.min() >= 1


def test_lengths_are_lognormal_with_the_stated_median_and_tail():
    plan = open_kind.generate(SHARED, 11, 51, 32768)
    out = SHARED["output_tokens"]
    outs = np.array([r.output for r in plan.window])
    assert outs.min() >= out["range"][0] and outs.max() <= out["range"][1]
    assert np.all(outs % 16 == 0)
    # The sources' figures: median 129 (rounded to 128), mean near 182.
    assert np.median(outs) == pytest.approx(out["median"], abs=16)
    assert outs.mean() == pytest.approx(182, rel=0.05)
    # Heavy-tailed: the longest tenth is well over twice the median.
    assert np.percentile(outs, 90) > 2.5 * np.median(outs)
    prompts = np.array([len(r.prompt) for r in plan.window])
    assert prompts.max() > 2 * np.median(prompts)


def test_uniform_lengths_stay_as_stated():
    plan = open_kind.generate(UNIFORM, 7, 30, 32768)
    lo, hi = UNIFORM["output_tokens"]
    outs = np.array([r.output for r in plan.window])
    assert outs.min() >= lo and outs.max() <= hi and np.all(outs % 16 == 0)
    assert outs.mean() == pytest.approx((lo + hi) / 2, rel=0.05)
    assert all(r.group is None and len(r.prompt) <= 4096 for r in plan.window)


def test_lognormal_set_is_sorted_cut_and_rounded():
    vals = lognormal_set(200, 129, 0.83, 16, 1024, 16)
    assert list(vals) == sorted(vals) and vals.min() >= 16 and vals.max() <= 1024
    assert np.all(vals % 16 == 0) and np.median(vals) == 128


def test_shared_prefix_popularity_is_zipf():
    plan = open_kind.generate(SHARED, 3, 40, 32768)
    groups = np.bincount([r.group for r in plan.window], minlength=128)
    share = groups / groups.sum()
    weights = 1 / np.arange(1, 129)
    assert share[0] == pytest.approx(weights[0] / weights.sum(), abs=0.01)
    assert groups[0] >= groups[1] >= groups[10]
    # Requests of a group share its prefix, whose length is in range.
    by_group = {}
    for r in plan.window:
        by_group.setdefault(r.group, []).append(r.prompt)
    lo, hi = SHARED["prompt"]["shared_prefix"]["tokens"]["range"]
    for prompts in by_group.values():
        if len(prompts) > 1:
            common = 0
            while all(p[common] == prompts[0][common] for p in prompts):
                common += 1
            assert lo <= common <= hi + 16
    assert len(plan.setup) == SHARED["prompt"]["shared_prefix"]["warm_groups"]
    assert [r.group for r in plan.setup] == list(range(len(plan.setup)))


def test_zipf_counts_add_up():
    counts = open_kind.zipf_counts(150, 128, 1.0)
    assert counts.sum() == 150 and counts[0] == counts.max()


def test_closed_loop_streams_start_mid_generation():
    mix = LONG_DECODE
    plan = closed_kind.generate(mix, BIG_SEED, 30, 102400)
    assert len(plan.setup) == mix["streams"] and all(r.running_at_start for r in plan.setup)
    assert all(len(q) == mix["requests_per_stream"] - 1 for q in plan.streams)
    for r in plan.setup + [r for q in plan.streams for r in q]:
        assert len(r.prompt) + r.output <= mix["max_context"]
        assert len(r.prompt) % 16 == 0 and r.output >= 16
    made = [len(r.prompt) for r in plan.setup]
    assert max(made) > mix["prompt"]["unique_tokens"][1]  # some have generated a lot already
    other = closed_kind.generate(mix, BIG_SEED + 5, 30, 102400)
    assert sorted(r.output for r in plan.setup) == sorted(r.output for r in other.setup)


def test_strata_are_the_uniform_midpoints():
    rng = np.random.default_rng(0)
    vals = strata(4, 0, 48, 16, rng)
    assert sorted(vals) == [0, 16, 32, 48]


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    (tmp_path / "traffic").mkdir()
    mix = dict(UNIFORM, rate_per_s=2.0)
    (tmp_path / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    assert spec.load_traffic("tiny-mix", tmp_path / "traffic")["rate_per_s"] == 2.0
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "queue.depth-p50.py").write_text(
        "def read(rec):\n    return rec.get('depth')\n")
    reader = spec.metric_reader("queue.depth-p50", tmp_path / "metrics")
    assert reader.read({"depth": 3.5}) == 3.5 and reader.read({}) is None
    assert spec.traffic_kind("open").generate is not None


def test_benchmark_names_every_file_it_needs():
    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(root / "BENCHMARK.json", w["name"])
        spec.traffic_kind(cell.traffic["kind"])
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
    for c in bench["configs"]:
        data = json.loads((root / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
