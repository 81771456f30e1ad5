"""The seeded open-loop schedule and the due-time latency arithmetic."""

import numpy as np

from benchmark import schedule


def test_same_seed_same_schedule_and_seeds_share_the_gaps():
    a = schedule.poisson(2**31 + 5, 160.0, 20.0, 64)
    b = schedule.poisson(2**31 + 5, 160.0, 20.0, 64)
    c = schedule.poisson(99, 160.0, 20.0, 64)
    assert np.array_equal(a.due, b.due) and np.array_equal(a.clips, b.clips)
    assert len(a.due) == len(c.due) == 3200
    assert not np.array_equal(a.due, c.due)
    ga, gc = np.sort(np.diff(a.due)), np.sort(np.diff(c.due))
    assert np.allclose(np.median(ga), np.median(gc), rtol=0.05)


def test_schedule_spans_the_window_at_the_rate():
    s = schedule.poisson(7, 100.0, 10.0, 8)
    assert s.due[0] == 0.0 and np.all(np.diff(s.due) >= 0)
    assert 9.8 < s.due[-1] < 10.0
    gaps = np.diff(s.due)
    assert abs(gaps.mean() - 0.01) < 0.001
    assert 0.8 < gaps.std() / gaps.mean() < 1.2  # exponential: std about the mean
    assert set(np.bincount(s.clips)) == {125}  # every pool clip equally often


def test_latency_from_due_time_and_a_stall_raises_the_p95():
    s = schedule.poisson(3, 200.0, 10.0, 16)
    service = 0.02
    ok = np.ones(len(s.due), bool)
    # a server that answers each request 20 ms after it is sent, on time
    recv = s.due + service
    base = schedule.p95(schedule.latencies(s.due, recv, ok, 5.0))
    assert abs(base - service) < 1e-9
    # a 2-s stall from t = 4 s: every request due in it is sent, and
    # answered, only when it ends
    stall = (s.due >= 4.0) & (s.due < 6.0)
    sent = np.where(stall, 6.0, s.due)
    recv = sent + service
    assert schedule.p95(schedule.latencies(s.due, recv, ok, 5.0)) > 0.5
    # timed from the send instead of the due time, the stall would not show
    assert schedule.p95(recv - sent) < 0.03


def test_failures_count_at_the_timeout():
    due = np.zeros(20)
    recv = np.full(20, 0.1)
    ok = np.ones(20, bool)
    ok[:2] = False
    lat = schedule.latencies(due, recv, ok, 30.0)
    assert lat.max() == 30.0 and schedule.p95(lat) > 1.0
