"""The paper's `rbh-report` tables from the profile cube, on the port.

Simulates a catalog (users, groups, sizes, ages, HSM states), builds the
incremental :class:`ProfileCube`, and prints the ownership / type / HSM /
size-profile / age-profile tables — every table a masked reduction over
one (measure, group, size_bucket, age_bucket) tensor, never a catalog
scan. Then mutates the catalog and re-queries: the cube absorbs the
deltas as signed bucket updates instead of recomputing.

The port of ``examples/fs_profiles.py``: the same catalog, cube and
tables through ``repro_torch``; ``--device`` (default the card) is where
the ``ProfileCube`` resolves its device. As in the reference the cube is
built by the exact int64 host groupby (``use_kernel`` defaults to
False); ``ProfileCube(..., use_kernel=True)`` builds it with the
``profile_cube`` kernel instead, whose f32 cells hold exactly only while
a cell's sums stay below 2**24.

    PYTHONPATH=src python examples/torch_fs_profiles.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import (Catalog, Entry, FsType, HsmState,
                              ProfileCube, Reports, format_size)


def build_catalog(n: int = 50_000) -> Catalog:
    rng = np.random.default_rng(42)
    now = time.time()
    cat = Catalog(n_shards=4)
    users = ["alice", "bob", "carol", "dave"]
    groups = ["physics", "bio", "ops"]
    for lo in range(0, n, 10_000):
        entries = []
        for i in range(lo, min(lo + 10_000, n)):
            kind = FsType.FILE if i % 10 else FsType.DIR
            entries.append(Entry(
                fid=i + 1, name=f"f{i}", path=f"/proj/d{i % 37}/f{i}",
                type=kind,
                size=int(rng.lognormal(9, 3)) if kind == FsType.FILE else 0,
                blocks=int(rng.lognormal(9, 3)),
                owner=users[i % len(users)], group=groups[i % len(groups)],
                hsm_state=HsmState(int(rng.choice(
                    [0, 0, 0, 1, 3, 4], p=[.4, .1, .1, .1, .2, .1]))),
                atime=now - float(rng.uniform(0, 500 * 86400))))
        cat.upsert_batch(entries)
    return cat


def show(title: str, lines) -> None:
    print(f"\n== {title} " + "=" * max(1, 60 - len(title)))
    for ln in lines:
        print(ln)


def main(device=None) -> None:
    cat = build_catalog()
    t0 = time.perf_counter()
    cube = ProfileCube(cat, device=device).attach()   # per-shard build
    print(f"profile cube over {len(cat)} entries built in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    rep = Reports(cat, profiles=cube)

    # rbh-report -u alice
    show("rbh-report -u alice", [rep.format_user_report("alice")])

    # per-type + per-HSM-state tables
    show("entry types", (f"  {t:8s} count={d['count']:<8d} "
                         f"volume={format_size(d['volume'])}"
                         for t, d in rep.report_types().items()))
    show("HSM states", (f"  {s:10s} count={d['count']:<8d} "
                        f"volume={format_size(d['volume'])}"
                        for s, d in rep.report_hsm().items()))

    # the paper's size + age profiles
    show("size profile (alice, files)",
         (f"  {lbl:>8s}: {n}" for lbl, n in
          rep.user_size_profile("alice").items() if n))
    show("age profile (all users)",
         (f"  {lbl:>8s}: count={d['count']:<8d} "
          f"volume={format_size(d['volume'])}"
          for lbl, d in rep.age_profile().items() if d["count"]))
    show("top users by volume",
         (f"  {d['user']:8s} {format_size(d['volume'])}"
          for d in rep.top_users(k=3)))

    # churn: the cube absorbs deltas as signed bucket updates — verify the
    # incrementally-maintained state against a from-scratch rebuild
    before = rep.report_user("bob")
    for fid in range(1, 2001):
        cat.update_fields(fid, size=0, blocks=0)
    for fid in range(2001, 3001):
        cat.remove(fid)
    after = rep.report_user("bob")
    fresh = ProfileCube(cat, device=device)
    fresh.rebuild()
    assert after == fresh.report_user("bob"), "incremental != recompute"
    show("after churn (2000 truncates + 1000 unlinks)", [
        f"  bob files before: {before[0]['count']}",
        f"  bob files after:  {after[0]['count']}",
        "  incremental cube == fresh rebuild: verified",
    ])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
