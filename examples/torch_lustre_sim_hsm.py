"""The paper's headline scenario end-to-end on the simulated Lustre, on
the port:

changelog-driven mirror -> O(1) accounting -> HSM archival -> OST
watermark purge -> transparent restore -> undelete.

The port of ``examples/lustre_sim_hsm.py``: the same scenario through
``repro_torch``; ``--device`` (default the card) is the policy engine's.

    PYTHONPATH=src python examples/torch_lustre_sim_hsm.py [--device cpu]
"""
import argparse
import time

from repro_torch.core import (AlertManager, AlertRule, Catalog,
                              EventPipeline, HsmCoordinator, PipelineConfig,
                              PolicyEngine, Reports, Scanner, StatsAggregator)
from repro_torch.fs import HsmBackend, LustreSim


def main(device=None) -> None:
    fs = LustreSim(n_osts=4, ost_capacity=200_000, n_mdts=2,
                   hsm=HsmBackend())
    home = fs.mkdir(fs.root_fid(), "home")
    ann = fs.mkdir(home, "ann", owner="ann")
    bob = fs.mkdir(home, "bob", owner="bob")

    catalog = Catalog(n_shards=4)
    stats = StatsAggregator(catalog.strings)
    catalog.add_delta_hook(stats.on_delta)
    alerts = AlertManager()
    alerts.add_rule(AlertRule("huge_file", "size > 64k"))
    catalog.add_entry_hook(alerts.on_entry)

    Scanner(fs, catalog, n_threads=2).scan()
    pipes = [EventPipeline(fs, catalog, fs.changelog.stream(m),
                           PipelineConfig()) for m in range(2)]

    print("== users write data; the DB follows via MDT changelogs ==")
    for i in range(60):
        owner, d = ("ann", ann) if i % 2 else ("bob", bob)
        f = fs.create(d, f"run{i}.out", owner=owner, uid=owner,
                      jobid=f"job{i % 4}")
        fs.write(f, 5000 + 1000 * (i % 30), uid=owner)
    for p in pipes:
        p.process_once(10_000)
    rep = Reports(catalog, stats)
    print(rep.format_user_report("ann"))
    print("alerts fired:", len(alerts.fired))
    for o in fs.osts:
        print(f"  OST{o.index}: {o.usage_pct:.1f}% used")

    print("\n== archive everything old enough, then watermark purge ==")
    engine = PolicyEngine(catalog, device=device)
    coord = HsmCoordinator(fs, catalog, engine, archive_age="0s",
                           high_wm=40.0, low_wm=15.0)
    r = coord.archive_pass()
    print(f"archived {r.succeeded} files "
          f"({r.volume} bytes) to the HSM backend")
    for rr in coord.space_check():
        print(f"purge[{rr.trigger}]: released {rr.succeeded} files, "
              f"freed {rr.volume} bytes")
    for o in fs.osts:
        print(f"  OST{o.index}: {o.usage_pct:.1f}% used")
    for p in pipes:
        p.process_once(10_000)
    print("HSM states:", {k: v["count"]
                          for k, v in stats.report_hsm().items()})

    print("\n== transparent restore on read ==")
    released = [e for e in catalog.entries() if e.hsm_state == 4]
    victim = released[0]
    size = fs.read(victim.fid, uid="ann")
    print(f"read {victim.path}: {size} bytes "
          f"(now {fs.stat(victim.fid).hsm_state.name})")

    print("\n== undelete ==")
    target = [e for e in catalog.entries() if e.hsm_state in (3, 4)
              and e.fid != victim.fid][0]
    fs.unlink(target.fid)
    print(f"deleted {target.path}; undeleting from the archive...")
    new_fid = coord.undelete(target.fid, ann, "recovered.out")
    print(f"recovered as fid {new_fid}: {fs.stat(new_fid).size} bytes")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
