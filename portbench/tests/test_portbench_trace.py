"""The trace's interval arithmetic and breakdown on hand-made events."""

import pytest

from portbench import devtrace
from portbench.devtrace import Op, Span, Trace


def test_union_clip_gaps_intersect():
    u = devtrace.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)])
    assert u == [(0, 2.5), (3, 4)]
    assert devtrace.clip(u, 1, 3.5) == [(1, 2.5), (3, 3.5)]
    assert devtrace.gaps(u, 0, 5) == [(2.5, 3), (4, 5)]
    assert devtrace.intersect(u, [(2, 3.5)]) == [(2, 2.5), (3, 3.5)]
    assert devtrace.total(u) == pytest.approx(3.5)


def _trace():
    ops = [Op("k1", 0.0, 1.0, 7), Op("k1", 0.5, 1.5, 13), Op("mul", 3.0, 3.5, 13)]
    spans = [Span("pb.survey", 0.0, 4.0, 1), Span("pb.shot", 0.0, 1.5, 2),
             Span("pb.shot", 2.0, 3.6, 2)]
    return Trace(window=(0.0, 4.0), ops=ops, spans=spans)


def test_busy_is_the_union_of_concurrent_streams():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(2.0)
    assert tr.closing_streams(tr.spans_named("pb.survey")) == {13}


def test_breakdown_names_ops_and_gaps():
    b = devtrace.breakdown(_trace())
    assert b["device_ops"][0] == ["k1", pytest.approx(2.0)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # a gap is named by the spans open where it begins: 1.5-3.0 after the
    # first shot ended, 3.5-4.0 inside the second
    assert gaps["pb.survey"] == pytest.approx(1.5)
    assert gaps["pb.shot+pb.survey"] == pytest.approx(0.5)
