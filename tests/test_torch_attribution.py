"""The port's usage attribution plane
(multiverso_tpu_torch/telemetry/attribution.py), the cases of
tests/test_attribution.py mirrored: space-saving top-K error bounds
under adversarial eviction streams, cross-member sketch merge vs a
single-stream sketch, count-min overestimate-only semantics, table heat
histograms, the plane's record/shed/topk_doc surface and the fleet
``merge_topk`` aggregation. The case here holds the port's ``topk_doc``
against the reference's for the same stream; ``/topk`` over HTTP is
served by the port's statusz (``tests/test_torch_statusz.py``).

Sketch properties are asserted against exact ground-truth counts kept
alongside the stream — the classic space-saving guarantees are
``true <= estimate <= true + error`` for every tracked key and
``error <= N / K`` for total stream weight N and capacity K.
"""

import collections

import pytest

from multiverso_tpu.telemetry import attribution as ref_attr
from multiverso_tpu_torch.telemetry import attribution as attr
from multiverso_tpu_torch.telemetry import metrics, timeseries


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MVTPU_TOPK_K", raising=False)
    monkeypatch.delenv("MVTPU_TOPK_HEAT", raising=False)
    metrics.registry().reset()
    attr._reset_for_tests()
    timeseries._reset_for_tests()
    yield
    metrics.registry().reset()
    attr._reset_for_tests()
    timeseries._reset_for_tests()


def zipfish_stream(n_keys=200, base=400, flood=1500):
    """Deterministic skewed stream: ``k0`` is a clear flooder, key i
    otherwise appears ~base/(i+1) times, round-robin interleaved so
    evictions keep happening (adversarial for the replace-min
    policy)."""
    remaining = [flood] + [max(1, base // (i + 1))
                           for i in range(1, n_keys)]
    out = []
    live = True
    while live:
        live = False
        for i, r in enumerate(remaining):
            if r > 0:
                out.append(f"k{i}")
                remaining[i] = r - 1
                live = True
    return out


class TestSpaceSaving:
    def test_exact_below_capacity(self):
        s = attr.SpaceSaving(k=16)
        for key, n in (("a", 5), ("b", 3), ("c", 1)):
            for _ in range(n):
                s.add(key)
        assert s.top(3) == [("a", 5.0, 0.0), ("b", 3.0, 0.0),
                            ("c", 1.0, 0.0)]
        assert s.min_count == 0          # not full: nothing evicted

    def test_error_bound_under_adversarial_eviction(self):
        k = 8
        s = attr.SpaceSaving(k=k)
        truth: collections.Counter = collections.Counter()
        stream = zipfish_stream()
        for key in stream:
            s.add(key)
            truth[key] += 1
        n = len(stream)
        assert s.min_count <= n / k
        for key, est, err in s.top(k):
            true = truth[key]
            assert true <= est <= true + err
            assert err <= n / k

    def test_heavy_hitter_survives_churn(self):
        s = attr.SpaceSaving(k=4)
        # one flooder + an endless parade of one-hit keys trying to
        # wash it out of the summary
        for i in range(500):
            s.add("flood")
            s.add(f"noise{i}")
        key, est, err = s.top(1)[0]
        assert key == "flood"
        assert est - err >= 400

    def test_weighted_add(self):
        s = attr.SpaceSaving(k=4)
        s.add("big", weight=1000)
        for i in range(20):
            s.add(f"small{i}", weight=1)
        assert s.top(1)[0][0] == "big"
        assert s.estimate("big") >= 1000

    def test_estimate_untracked_returns_min_count(self):
        s = attr.SpaceSaving(k=2)
        for key in ("a", "a", "b", "b", "c"):
            s.add(key)
        evicted = next(x for x in ("a", "b", "c")
                       if x not in {r[0] for r in s.top(2)})
        assert s.estimate(evicted) == s.min_count
        assert s.min_count > 0

    def test_merge_matches_single_stream_within_bound(self):
        k = 8
        stream = zipfish_stream()
        half = len(stream) // 2
        a, b = attr.SpaceSaving(k=k), attr.SpaceSaving(k=k)
        truth: collections.Counter = collections.Counter(stream)
        for key in stream[:half]:
            a.add(key)
        for key in stream[half:]:
            b.add(key)
        m = a.merge(b)
        n = len(stream)
        # merged sketch keeps the space-saving guarantee over the
        # UNION stream: never undercounts below true - err, never
        # exceeds true + combined floor
        for key, est, err in m.top(k):
            true = truth[key]
            assert est + err >= true
            assert est <= true + err
            assert err <= 2 * n / k     # floors add across members
        # and the dominant key agrees with a single-stream sketch
        single = attr.SpaceSaving(k=k)
        for key in stream:
            single.add(key)
        assert m.top(1)[0][0] == single.top(1)[0][0]

    def test_merge_is_commutative_on_top_key(self):
        a, b = attr.SpaceSaving(k=4), attr.SpaceSaving(k=4)
        for _ in range(50):
            a.add("x")
        for _ in range(30):
            b.add("y")
        assert a.merge(b).top(1)[0][0] == "x"
        assert b.merge(a).top(1)[0][0] == "x"


class TestCountMin:
    def test_never_underestimates(self):
        cm = attr.CountMin()
        truth: collections.Counter = collections.Counter()
        for key in zipfish_stream(n_keys=400):
            cm.add(key)
            truth[key] += 1
        for key, true in truth.items():
            assert cm.estimate(key) >= true

    def test_rows_deterministic_across_instances(self):
        a, b = attr.CountMin(), attr.CountMin()
        a.add("some|key|op", weight=7)
        b.add("some|key|op", weight=7)
        assert a.estimate("some|key|op") == b.estimate("some|key|op")

    def test_merge_is_additive(self):
        a, b = attr.CountMin(), attr.CountMin()
        a.add("k", weight=10)
        b.add("k", weight=32)
        assert a.merge(b).estimate("k") >= 42
        assert a.estimate("unseen") == 0


class TestHeat:
    def test_touch_span_spreads_proportionally(self):
        h = attr.Heat("element", 0, 100, buckets=10)
        h.touch_span(0, 100, weight=100.0)      # uniform over range
        doc = h.to_doc()
        assert doc["counts"] == [pytest.approx(10.0)] * 10
        assert doc["total"] == pytest.approx(100.0)
        assert (doc["space"], doc["lo"], doc["hi"]) \
            == ("element", 0, 100)

    def test_touch_span_partial_overlap(self):
        h = attr.Heat("element", 0, 100, buckets=10)
        h.touch_span(5, 15, weight=10.0)  # half bucket 0, half bucket 1
        doc = h.to_doc()
        assert doc["counts"][0] == pytest.approx(5.0)
        assert doc["counts"][1] == pytest.approx(5.0)
        assert sum(doc["counts"][2:]) == 0

    def test_touch_span_clips_to_owned_range(self):
        h = attr.Heat("element", 100, 200, buckets=10)
        h.touch_span(0, 110, weight=10.0)   # only [100,110) is ours
        assert h.to_doc()["counts"][0] == pytest.approx(10.0)
        h.touch_span(900, 999)              # fully out of range: noop
        assert h.to_doc()["total"] == pytest.approx(10.0)

    def test_touch_positions(self):
        h = attr.Heat("bucket", 0, 10, buckets=10)
        h.touch_positions([0, 0, 9, 42])    # 42 out of range: dropped
        doc = h.to_doc()
        assert doc["counts"][0] == pytest.approx(2.0)
        assert doc["counts"][9] == pytest.approx(1.0)
        assert doc["total"] == pytest.approx(3.0)


class TestPlane:
    def test_record_and_topk_doc(self):
        p = attr.AttributionPlane(k=8)
        for _ in range(10):
            p.record("trainer0", "emb", "get", n_bytes=4096,
                     queue_ms=2.0)
        p.record("logger", "stats", "add")
        p.shed("bully", "emb", "add")
        doc = p.topk_doc(n=5)
        assert doc["kind"] == attr.TOPK_KIND
        assert set(doc["dims"]) >= {"ops", "bytes", "queue_ms",
                                    "sheds"}
        ops = doc["dims"]["ops"]
        assert ops["top"][0]["client"] == "trainer0"
        assert ops["top"][0]["table"] == "emb"
        assert ops["top"][0]["op"] == "get"
        assert ops["top"][0]["estimate"] == 10
        assert ops["total"] == 11
        assert doc["dims"]["bytes"]["top"][0]["estimate"] == 40960
        assert doc["dims"]["sheds"]["top"][0]["client"] == "bully"

    def test_zero_weight_dims_not_polluted(self):
        p = attr.AttributionPlane(k=8)
        p.record("c", "t", "get")           # no bytes, no queueing
        doc = p.topk_doc(n=5)
        assert doc["dims"]["ops"]["total"] == 1
        assert doc["dims"]["bytes"]["total"] == 0
        assert doc["dims"]["bytes"]["top"] == []

    def test_estimate_answers_any_key(self):
        p = attr.AttributionPlane(k=2)
        for i in range(40):
            p.record(f"c{i % 10}", "t", "get")
        # even clients evicted from the top-K sketch answer through
        # the count-min backing sketch (overestimate-only)
        assert p.estimate("ops", "c7", "t", "get") >= 4
        assert p.estimate("ops", "never-seen", "t", "get") >= 0

    def test_heat_in_doc(self):
        p = attr.AttributionPlane(k=8)
        h = p.heat("emb", "element", 0, 1000)
        h.touch_span(0, 1000, weight=500.0)
        doc = p.topk_doc(n=5)
        assert "emb" in doc["heat"]
        assert doc["heat"]["emb"]["total"] == pytest.approx(500.0)

    def test_heat_replaced_on_reshard(self):
        p = attr.AttributionPlane(k=8)
        h = p.heat("emb", "element", 0, 1000)
        h.touch_span(0, 1000, weight=100.0)
        # resharding moved this member's owned range: stale heat over
        # a range it no longer owns must be dropped, not kept
        h2 = p.heat("emb", "element", 500, 1500)
        assert h2 is not h
        assert p.topk_doc()["heat"]["emb"]["total"] == 0
        assert p.heat("emb", "element", 500, 1500) is h2  # stable now

    def test_plane_env_gating(self, monkeypatch):
        monkeypatch.setenv("MVTPU_TOPK_K", "0")
        attr._reset_for_tests()
        assert attr.plane() is None
        monkeypatch.setenv("MVTPU_TOPK_K", "16")
        attr._reset_for_tests()
        p = attr.plane()
        assert p is not None and p.k == 16
        assert attr.plane() is p            # singleton


class TestMergeTopk:
    def _doc(self, client, n, lo=0):
        p = attr.AttributionPlane(k=8)
        for _ in range(n):
            p.record(client, "emb", "get", n_bytes=100)
        p.heat("emb", "element", lo, lo + 100) \
            .touch_span(lo, lo + 100, weight=float(n))
        return p.topk_doc(n=8)

    def test_merge_sums_across_members(self):
        m = attr.merge_topk([self._doc("a", 30, lo=100),
                             self._doc("b", 10, lo=0),
                             self._doc("a", 5, lo=200)])
        assert m["kind"] == attr.TOPK_KIND
        assert m["members"] == 3
        ops = m["dims"]["ops"]
        assert ops["total"] == 45
        assert ops["top"][0]["client"] == "a"
        assert ops["top"][0]["estimate"] >= 35
        # heat is NOT summed: each member owns a disjoint range, so
        # the fleet strip is the per-member list sorted by range start
        strips = m["heat"]["emb"]
        assert [s["lo"] for s in strips] == [0, 100, 200]
        assert [s["total"] for s in strips] == [10.0, 30.0, 5.0]

    def test_merge_floor_substitution(self):
        # a key one member never reports gets that member's eviction
        # floor added to BOTH estimate and error — bounds stay honest
        a = attr.AttributionPlane(k=2)
        for key, n in (("x", 10), ("y", 8), ("z", 5)):
            for _ in range(n):
                a.record(key, "t", "get")
        b = attr.AttributionPlane(k=2)
        for key, n in (("w", 20), ("v", 3)):
            for _ in range(n):
                b.record(key, "t", "get")
        da, db = a.topk_doc(), b.topk_doc()
        floor_a = da["dims"]["ops"]["min_count"]
        assert floor_a > 0              # a's sketch is full
        m = attr.merge_topk([da, db])
        top = {e["client"]: e for e in m["dims"]["ops"]["top"]}
        # "w" is absent from a's report: a's floor is added to both
        wb = next(e for e in db["dims"]["ops"]["top"]
                  if e["client"] == "w")
        assert top["w"]["estimate"] == wb["estimate"] + floor_a
        assert top["w"]["error"] >= floor_a
        assert m["dims"]["ops"]["min_count"] \
            == floor_a + db["dims"]["ops"]["min_count"]

    def test_merge_rejects_bad_input(self):
        with pytest.raises(ValueError):
            attr.merge_topk([])
        with pytest.raises(ValueError):
            attr.merge_topk([{"kind": "something.else"}])


class TestTopkEndpoint:
    def test_topk_doc_equals_reference(self, monkeypatch):
        monkeypatch.setenv("MVTPU_TOPK_K", "16")
        attr._reset_for_tests()
        ref_attr._reset_for_tests()
        docs = []
        for mod in (attr, ref_attr):
            p = mod.plane()
            for i, key in enumerate(zipfish_stream(n_keys=40, base=30,
                                                   flood=90)):
                p.record(key, "emb", "get", n_bytes=256 + i % 3,
                         queue_ms=0.5 * (i % 4))
                if i % 11 == 0:
                    p.shed(key, "emb", "add")
            p.heat("emb", "bucket", 0, 64).touch_span(3, 40, 2.0)
            doc = p.topk_doc(n=3)
            doc.pop("ts", None)
            docs.append(doc)
        ref_attr._reset_for_tests()
        assert docs[0] == docs[1]
        assert docs[0]["kind"] == attr.TOPK_KIND
        top = docs[0]["dims"]["ops"]["top"]
        assert top and top[0]["client"] == "k0"
