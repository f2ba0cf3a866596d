"""``tests/core/test_changelog.py`` on the port, held against ``repro``.

MDT changelog streams: acks and purges, crash re-delivery from the
persist directory, cursor resets, named subscribers with their own
cursors, clamped over-acks, the multi-MDT hub's round-robin reads and the
columnar read. ``core/changelog.py`` of the port is a byte copy of the
reference's (``tests/test_torch_copies.py``). Cases that yield delivered
sequence numbers run on both packages (each in a directory of its own)
and must deliver the same ones; the retention and fairness invariants run
on the port.
"""
import threading

import pytest

pytest.importorskip("torch")

from torch_pair import both, port


def _seqs(recs):
    return [r.seq for r in recs]


def _ack_purges(P):
    s = P.ChangelogStream()
    for fid in range(1, 6):
        s.emit(P.ChangelogType.CREAT, fid)
    first = _seqs(s.read(max_records=3))
    assert first == [1, 2, 3]
    assert s.pending() == 5         # nothing acked yet
    s.ack(3)
    assert s.pending() == 2
    rest = _seqs(s.read())
    assert rest == [4, 5]
    return first, rest


def test_ack_purges_and_pending():
    both(_ack_purges)


def _crash_redelivery(P, tmp_path):
    """Paper SII-C2: unacked records survive a consumer crash."""
    d = tmp_path / P.name
    d.mkdir()
    s = P.ChangelogStream(mdt=0, persist_dir=str(d))
    for fid in range(1, 11):
        s.emit(P.ChangelogType.CREAT, fid)
    s.read(max_records=7)
    s.ack(4)                        # only 4 committed before the "crash"
    s.close()
    # restart: a fresh stream on the same dir re-delivers 5..10
    s2 = P.ChangelogStream(mdt=0, persist_dir=str(d))
    recs = s2.read(max_records=100)
    assert _seqs(recs) == list(range(5, 11))
    # and new records continue the sequence
    r = s2.emit(P.ChangelogType.UNLNK, 99)
    assert r.seq == 11
    s2.close()
    return [(x.seq, int(x.type), x.fid) for x in recs]


def test_crash_redelivery_no_loss(tmp_path):
    both(_crash_redelivery, tmp_path)


def test_reset_cursor_redelivers():
    P = port()
    s = P.ChangelogStream()
    for fid in range(3):
        s.emit(P.ChangelogType.MKDIR, fid)
    s.read()
    s.ack(1)
    s.reset_cursor()
    assert _seqs(s.read()) == [2, 3]


def test_named_subscribers_have_independent_cursors():
    P = port()
    s = P.ChangelogStream()
    for fid in range(1, 4):
        s.emit(P.ChangelogType.CREAT, fid)
    s.subscribe("engine")                  # starts at the head: future only
    s.emit(P.ChangelogType.CREAT, 4)
    assert _seqs(s.read(subscriber="engine")) == [4]
    assert _seqs(s.read()) == [1, 2, 3, 4]  # default unaffected
    s.ack(4)                               # default acks everything...
    assert s.pending() == 0
    # ...but records 4+ survive until "engine" acks too
    s.reset_cursor(subscriber="engine")
    assert _seqs(s.read(subscriber="engine")) == [4]
    s.ack(4, subscriber="engine")
    assert s.pending(subscriber="engine") == 0


def test_subscribe_from_start_sees_retained_records():
    P = port()
    s = P.ChangelogStream()
    for fid in range(1, 4):
        s.emit(P.ChangelogType.CREAT, fid)
    s.subscribe("auditor", from_start=True)
    assert _seqs(s.read(subscriber="auditor")) == [1, 2, 3]


def test_laggard_subscriber_holds_back_purge_until_unsubscribed():
    P = port()
    s = P.ChangelogStream()
    s.subscribe("slow")
    for fid in range(1, 6):
        s.emit(P.ChangelogType.CREAT, fid)
    s.read(max_records=100)
    s.ack(5)                               # default fully acked
    assert len(s._records) == 5            # retained for "slow"
    s.unsubscribe("slow")
    assert len(s._records) == 0            # released


def _subscriber_acks(P, tmp_path):
    d = tmp_path / P.name
    d.mkdir()
    s = P.ChangelogStream(mdt=0, persist_dir=str(d))
    s.subscribe("engine", from_start=True)
    for fid in range(1, 8):
        s.emit(P.ChangelogType.CREAT, fid)
    s.read(max_records=100)
    s.ack(7)
    s.read(max_records=3, subscriber="engine")
    s.ack(3, subscriber="engine")
    s.close()
    # restart: both cursors recover; 4..7 redelivered to "engine" only
    s2 = P.ChangelogStream(mdt=0, persist_dir=str(d))
    assert s2.read(max_records=100) == []
    s2.subscribe("engine")
    redelivered = _seqs(s2.read(max_records=100, subscriber="engine"))
    assert redelivered == [4, 5, 6, 7]
    # an unregistered crashed subscriber still holds back purge
    s2.ack(7)
    assert len(s2._records) == 4
    s2.close()
    return redelivered


def test_subscriber_acks_survive_crash(tmp_path):
    both(_subscriber_acks, tmp_path)


def test_unsubscribe_after_recovery_releases_retention(tmp_path):
    P = port()
    d = str(tmp_path)
    s = P.ChangelogStream(mdt=0, persist_dir=d)
    s.subscribe("engine", from_start=True)
    for fid in range(1, 4):
        s.emit(P.ChangelogType.CREAT, fid)
    s.read(max_records=2, subscriber="engine")
    s.ack(2, subscriber="engine")
    s.close()
    s2 = P.ChangelogStream(mdt=0, persist_dir=d)
    s2.subscribe("engine")
    s2.unsubscribe("engine")           # decommissioned for good
    for fid in range(4, 10):
        s2.emit(P.ChangelogType.CREAT, fid)
    s2.read(max_records=100)
    s2.ack(9)
    assert len(s2._records) == 0       # stale recovered ack must not pin
    s2.close()
    s3 = P.ChangelogStream(mdt=0, persist_dir=d)
    assert s3.pending() == 0           # ...nor resurrect in the ack file
    s3.close()


def test_ack_beyond_head_is_clamped():
    P = port()
    s = P.ChangelogStream()
    for fid in range(1, 4):
        s.emit(P.ChangelogType.CREAT, fid)
    s.ack(100)                             # overshoot: clamped to seq 3
    assert s.acked == 3
    r = s.emit(P.ChangelogType.CREAT, 9)   # later records are NOT swallowed
    assert r.seq == 4
    assert _seqs(s.read()) == [4]


def test_hub_and_stream_close_are_idempotent(tmp_path):
    P = port()
    hub = P.ChangelogHub(n_mdts=2, persist_dir=str(tmp_path))
    hub.stream(0).emit(P.ChangelogType.CREAT, 1)
    hub.close()
    hub.close()                            # second close: no error
    hub.stream(1).close()                  # per-stream re-close: no error


def test_concurrent_producers_unique_seqs():
    P = port()
    s = P.ChangelogStream()

    def produce():
        for i in range(100):
            s.emit(P.ChangelogType.CREAT, i)

    threads = [threading.Thread(target=produce) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seqs = _seqs(s.read(max_records=1000))
    assert seqs == sorted(seqs) and len(set(seqs)) == 400


def _round_robin(P):
    """A burst on one MDT must not starve the others: every round-robin
    sweep serves each MDT up to one quantum."""
    hub = P.ChangelogHub(n_mdts=4)
    q = 64
    for i in range(40 * q):                       # 40-quantum burst, MDT 0
        hub.stream(0).emit(P.ChangelogType.CREAT, i + 1)
    for m in (1, 2, 3):
        for i in range(8):
            hub.stream(m).emit(P.ChangelogType.CLOSE, i + 1)

    sweeps = 0
    served_log = []
    while hub.total_pending():
        batches = hub.read_round_robin(quantum=q)
        assert batches, "pending records but an empty sweep"
        served = {cb.mdt for cb in batches}
        served_log.append([(cb.mdt, len(cb)) for cb in batches])
        for cb in batches:
            hub.stream(cb.mdt).ack(int(cb.seq[-1]))
        sweeps += 1
        if sweeps <= 3:
            assert served == {0, 1, 2, 3}         # no starvation
        for m in (1, 2, 3):
            assert hub.stream(m).pending() <= q, \
                f"mdt{m} starved behind the mdt0 burst"
        if sweeps <= 10:                          # live trickle continues
            for m in (1, 2, 3):
                hub.stream(m).emit(P.ChangelogType.CLOSE, 100 + sweeps)
        assert sweeps < 200
    assert sweeps >= 40                           # burst took many sweeps
    return served_log


def test_round_robin_bounded_lag_skew_under_single_mdt_burst():
    both(_round_robin)


def _rotates(P):
    hub = P.ChangelogHub(n_mdts=3)
    for m in range(3):
        for i in range(6):
            hub.stream(m).emit(P.ChangelogType.CREAT, i + 1)
    firsts = []
    for _ in range(3):
        batches = hub.read_round_robin(quantum=2)
        firsts.append(batches[0].mdt)
        for cb in batches:
            hub.stream(cb.mdt).ack(int(cb.seq[-1]))
    assert len(set(firsts)) == 3
    return firsts


def test_round_robin_rotates_start_mdt():
    both(_rotates)


def _columnar(P):
    s = P.ChangelogStream()
    for fid in range(1, 9):
        s.emit(P.ChangelogType.CREAT if fid % 2 else P.ChangelogType.UNLNK,
               fid)
    cb = s.read_columnar(max_records=5)
    assert cb is not None and len(cb) == 5
    assert cb.seq.tolist() == [1, 2, 3, 4, 5]
    assert cb.fid.tolist() == [1, 2, 3, 4, 5]
    C, U = int(P.ChangelogType.CREAT), int(P.ChangelogType.UNLNK)
    assert cb.type.tolist() == [C, U, C, U, C]
    assert _seqs(cb.records) == [1, 2, 3, 4, 5]
    rest = s.read_columnar(max_records=5)
    assert rest.seq.tolist() == [6, 7, 8]
    assert s.read_columnar(max_records=5, timeout=0.0) is None
    return [(c.seq.tolist(), c.fid.tolist(), c.type.tolist())
            for c in (cb, rest)]


def test_read_columnar_matches_read():
    both(_columnar)
