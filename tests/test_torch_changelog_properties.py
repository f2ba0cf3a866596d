"""``tests/core/test_changelog_properties.py`` on the port, held against
``repro``.

Arbitrary interleavings of emit / emit_batch / read / ack / reset_cursor,
crash recovery from the persist directory mid-batch and a second named
subscriber never lose or duplicate a record, and acked / pending stay
consistent. The state machine drives the port's ``ChangelogStream`` and
the reference's side by side with the same operations: each read must
deliver the model's records on both. Hypothesis runs derandomized with no
example database, so every run draws the same examples.
"""
import shutil
import tempfile

import pytest

pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import settings, strategies as st
from hypothesis.stateful import (RuleBasedStateMachine, initialize,
                                 invariant, rule)

from torch_pair import port, ref

SUB = "policy-engine"
DERANDOMIZED = dict(derandomize=True, database=None, deadline=None)


class StreamMachine(RuleBasedStateMachine):
    """Model: the stream is the sequence 1..emitted; each consumer owns a
    (cursor, acked) pair with acked <= cursor <= emitted. ``read`` returns
    exactly the contiguous run after the cursor, on both packages."""

    @initialize()
    def setup(self) -> None:
        self.pkgs = [ref(), port()]
        self.dirs = [tempfile.mkdtemp(prefix=f"chlog-prop-{P.name}-")
                     for P in self.pkgs]
        self.streams = [self._open(i) for i in range(2)]
        self.emitted = 0
        self.model = {None: [0, 0], SUB: [0, 0]}   # name -> [cursor, acked]

    def _open(self, i):
        s = self.pkgs[i].ChangelogStream(mdt=0, persist_dir=self.dirs[i])
        s.subscribe(SUB)
        return s

    def teardown(self) -> None:
        for s, d in zip(getattr(self, "streams", []), self.dirs):
            s.close()
            shutil.rmtree(d, ignore_errors=True)

    @rule(n=st.integers(1, 5))
    def emit(self, n) -> None:
        for _ in range(n):
            self.emitted += 1
            for P, s in zip(self.pkgs, self.streams):
                rec = s.emit(P.ChangelogType.CREAT, fid=self.emitted)
                assert rec.seq == self.emitted      # dense, monotonic seqs

    @rule(n=st.integers(1, 6))
    def emit_batch(self, n) -> None:
        for P, s in zip(self.pkgs, self.streams):
            s.emit_batch([P.ChangelogRecord(seq=0,
                                            type=P.ChangelogType.CLOSE,
                                            fid=i) for i in range(n)])
        self.emitted += n

    @rule(k=st.integers(1, 7), who=st.sampled_from([None, SUB]))
    def read(self, k, who) -> None:
        cursor = self.model[who][0]
        expect = list(range(cursor + 1, min(cursor + k, self.emitted) + 1))
        got = [[(r.seq, int(r.type), r.fid)
                for r in s.read(max_records=k, subscriber=who)]
               for s in self.streams]
        assert [seq for seq, _, _ in got[1]] == expect   # exactly once
        assert got[1] == got[0]
        if expect:
            self.model[who][0] = expect[-1]

    @rule(who=st.sampled_from([None, SUB]), frac=st.floats(0.0, 1.0))
    def ack_some(self, who, frac) -> None:
        cursor, acked = self.model[who]
        seq = acked + int((cursor - acked) * frac)
        for s in self.streams:
            s.ack(seq, subscriber=who)
        self.model[who][1] = max(acked, seq)
        self.model[who][0] = max(cursor, self.model[who][1])

    @rule(who=st.sampled_from([None, SUB]))
    def over_ack_is_clamped(self, who) -> None:
        """Acking past the head must not swallow later emissions."""
        for s in self.streams:
            s.ack(self.emitted + 5, subscriber=who)
        self.model[who] = [self.emitted, self.emitted]

    @rule(who=st.sampled_from([None, SUB]))
    def reset_cursor(self, who) -> None:
        for s in self.streams:
            s.reset_cursor(subscriber=who)
        self.model[who][0] = self.model[who][1]     # unacked re-delivered

    @rule()
    def crash_and_recover(self) -> None:
        """Close mid-stream; a fresh stream on the same dir re-delivers
        every unacked record to every subscriber."""
        for i, s in enumerate(self.streams):
            s.close()
            self.streams[i] = self._open(i)
        for who in self.model:
            self.model[who][0] = self.model[who][1]  # cursor back to acked
            for s in self.streams:
                assert s.pending(subscriber=who) == \
                    self.emitted - self.model[who][1]

    @invariant()
    def acked_and_pending_consistent(self) -> None:
        for s in self.streams:
            assert s.acked == self.model[None][1]
            assert s.acked_of(SUB) == self.model[SUB][1]
            for who in self.model:
                assert s.pending(subscriber=who) == \
                    self.emitted - self.model[who][1]


TestChangelogStreamProperties = StreamMachine.TestCase
TestChangelogStreamProperties.settings = settings(
    max_examples=40, stateful_step_count=30, **DERANDOMIZED)
TestChangelogStreamProperties = pytest.mark.slow(TestChangelogStreamProperties)


@pytest.mark.slow
@hypothesis.given(st.lists(st.integers(1, 50), min_size=1, max_size=20))
@settings(max_examples=50, **DERANDOMIZED)
def test_interleaved_batches_assign_dense_seqs(batch_sizes):
    got = []
    for P in (ref(), port()):
        s = P.ChangelogStream()
        for n in batch_sizes:
            s.emit_batch([P.ChangelogRecord(seq=0, type=P.ChangelogType.CREAT,
                                            fid=i) for i in range(n)])
        got.append([(r.seq, r.fid) for r in s.read(max_records=10 ** 6)])
    assert [seq for seq, _ in got[1]] == list(range(1, sum(batch_sizes) + 1))
    assert got[1] == got[0]
