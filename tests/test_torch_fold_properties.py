"""``tests/core/test_fold_properties.py`` on the port, held against
``repro``.

The vectorized last-write-wins fold (``fold_columnar``) equals the
record-order scalar fold on every interleaving of CREAT / UNLNK /
SETATTR / ... storms, and equals the reference's fold; the end-to-end
columnar pipeline lands on the catalog state of the record-at-a-time
oracle across arbitrary batch boundaries, and the port's mirror equals
the reference's over the same random workload (each package's own
``LustreSim`` driven by the same seeded program). The seeded sweeps
always run; the Hypothesis cases (``slow``, as in the reference) run
derandomized with no example database.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_pair import both, port, ref

_P = port()
_RM = (int(_P.ChangelogType.UNLNK), int(_P.ChangelogType.RMDIR))
_BORN = (int(_P.ChangelogType.CREAT), int(_P.ChangelogType.MKDIR))
_ALL_TYPES = [int(t) for t in _P.ChangelogType]


def scalar_fold(fids, types):
    """Record-order reference fold: dict insertion + last-write-wins."""
    first, last = {}, {}
    for f, t in zip(fids, types):
        if f not in first:
            first[f] = t
        last[f] = t
    survivors = sorted(f for f, t in last.items() if t not in _RM)
    removed = sorted(f for f, t in last.items() if t in _RM)
    annihilated = sorted(f for f in removed if first[f] in _BORN)
    dedup = len(fids) - len(last)
    return survivors, removed, annihilated, dedup


def _fold(P, fids, types):
    fr = P.fold_columnar(np.asarray(fids, dtype=np.int64),
                         np.asarray(types, dtype=np.int8))
    return (fr.survivors.tolist(), fr.removed.tolist(),
            fr.annihilated.tolist(), fr.dedup)


def _check_fold(fids, types, against_ref=True):
    got = _fold(_P, fids, types)
    survivors, removed, annihilated, dedup = scalar_fold(fids, types)
    assert got == (survivors, removed, annihilated, dedup)
    # removal classification and survivor set partition the uniques
    assert len(survivors) + len(removed) == len(set(fids))
    if against_ref:
        assert got == _fold(ref(), fids, types)


def test_fold_empty_and_singletons():
    _check_fold([], [])
    for t in _ALL_TYPES:
        _check_fold([7], [t])


def test_fold_create_unlink_annihilation():
    C, U, S = (int(_P.ChangelogType.CREAT), int(_P.ChangelogType.UNLNK),
               int(_P.ChangelogType.SATTR))
    _check_fold([1, 1], [C, U])
    # pre-existing fid removed: removed but NOT annihilated
    _check_fold([1, 1], [S, U])
    # removal then more records: the fold is still well-defined
    _check_fold([1, 1], [U, S])


def test_fold_setattr_storm_dedups():
    fids = [5] * 100 + [9]
    types = [int(_P.ChangelogType.SATTR)] * 100 + \
        [int(_P.ChangelogType.CREAT)]
    _check_fold(fids, types)
    survivors, _, _, dedup = _fold(_P, fids, types)
    assert dedup == 99 and survivors == [5, 9]


@pytest.mark.parametrize("seed", range(12))
def test_fold_random_interleavings(seed):
    """Seeded sweep: random fid reuse under every op type, sizes that
    straddle the no-duplicate fast path both ways."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 200))
        n_fids = int(rng.integers(1, max(2, n)))
        fids = rng.integers(1, n_fids + 1, size=n).tolist()
        types = rng.choice(_ALL_TYPES, size=n).tolist()
        _check_fold(fids, types)


# -- end-to-end batch-boundary invariance -------------------------------------

def _random_workload(P, rng, n_ops=250):
    """Random create/write/unlink/mkdir program against a 2-MDT sim."""
    fs = P.LustreSim(n_mdts=2)
    dirs = [fs.mkdir(fs.root_fid(), f"d{i}") for i in range(4)]
    live = []
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.35 or not live:
            f = fs.create(dirs[int(rng.integers(0, 4))],
                          f"f{int(rng.integers(0, 10 ** 9))}",
                          owner=f"u{int(rng.integers(0, 3))}",
                          uid=f"u{int(rng.integers(0, 3))}")
            live.append(f)
        elif op < 0.85:
            # hot-spot writes: 90% hit the first few files (dedup storm)
            if rng.random() < 0.9 and len(live) > 3:
                f = live[int(rng.integers(0, 3))]
            else:
                f = live[int(rng.integers(0, len(live)))]
            fs.write(f, int(rng.integers(1, 50)) * 10, uid="u0")
        else:
            fs.unlink(live.pop(int(rng.integers(0, len(live)))))
    # a never-acking subscriber pins the records so the same stream can
    # be replayed by several mirrors (acks purge otherwise)
    fs.changelog.subscribe("retain", from_start=True)
    return fs


def _mirror(P, fs, columnar, batch_size):
    cat = P.Catalog(n_shards=2)
    pipe = P.EventPipeline(fs, cat, fs.changelog,
                           P.PipelineConfig(columnar=columnar,
                                            batch_size=batch_size))
    pipe.process_once(10 ** 7)
    for s in fs.changelog.streams.values():
        s.reset_cursor()
        # rewind so the next mirror replays the same records
        sub = s._sub(None)
        sub.read_cursor = 0
        sub.acked = 0
    return {e.fid: (e.name, e.path, int(e.type), e.size, e.owner, e.group)
            for e in cat.entries()}


def _batch_invariance(P, seed):
    fs = _random_workload(P, np.random.default_rng(100 + seed))
    want = _mirror(P, fs, columnar=False, batch_size=512)
    for batch_size in (1, 3, 17, 128, 10 ** 6):
        assert _mirror(P, fs, columnar=True, batch_size=batch_size) == want, \
            f"columnar mirror diverged at batch_size={batch_size}"
    assert _mirror(P, fs, columnar=False, batch_size=7) == want
    return want


@pytest.mark.parametrize("seed", range(6))
def test_columnar_equals_oracle_across_batch_boundaries(seed):
    """The folded catalog mirror is invariant under batch size, equals the
    record-at-a-time oracle, and equals the reference's mirror."""
    assert both(_batch_invariance, seed)


# -- hypothesis layer (skipped when the package is absent) --------------------

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                   # seeded sweeps above still run
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    DERANDOMIZED = dict(derandomize=True, database=None, deadline=None)

    @pytest.mark.slow
    @given(st.lists(st.tuples(st.integers(1, 12),
                              st.sampled_from(_ALL_TYPES)),
                    max_size=300))
    @settings(max_examples=200, **DERANDOMIZED)
    def test_fold_matches_scalar_reference(ops):
        _check_fold([f for f, _ in ops], [t for _, t in ops])

    @pytest.mark.slow
    @given(st.integers(0, 2 ** 31 - 1), st.sampled_from([1, 5, 33, 10 ** 6]))
    @settings(max_examples=20, **DERANDOMIZED)
    def test_e2e_mirror_invariant_under_batching(seed, batch_size):
        def mirrors(P):
            fs = _random_workload(P, np.random.default_rng(seed), n_ops=120)
            want = _mirror(P, fs, columnar=False, batch_size=512)
            assert _mirror(P, fs, columnar=True,
                           batch_size=batch_size) == want
            return want
        both(mirrors)
