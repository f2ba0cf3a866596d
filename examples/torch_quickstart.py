"""Quickstart on the PyTorch port: Robinhood over a real directory tree.

Builds a temp POSIX tree, scans it in parallel into the catalog, then
answers find/du/report queries from the DB (never re-touching the FS).
The port of ``examples/quickstart.py``: the same tree, scan and queries
through ``repro_torch``. Nothing on this path takes a device (the
catalog, the scanner and the host reports); ``--device`` is accepted so
that every ``torch_*`` example is called the same way.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.core import Catalog, Reports, Scanner, StatsAggregator
from repro_torch.fs import PosixFs


def main(device=None) -> None:
    root = tempfile.mkdtemp(prefix="rbh_quickstart_")
    for d in ("projects/alpha", "projects/beta", "scratch"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(20):
        sub = ("projects/alpha", "projects/beta", "scratch")[i % 3]
        with open(os.path.join(root, sub, f"file{i}.dat"), "wb") as f:
            f.write(b"#" * (1000 * (i + 1)))

    # 1. collect: parallel depth-first scan into the catalog
    fs = PosixFs(root)
    catalog = Catalog(n_shards=2)
    stats = StatsAggregator(catalog.strings)
    catalog.add_delta_hook(stats.on_delta)
    scan = Scanner(fs, catalog, n_threads=4).scan()
    print(f"scanned {scan.entries} entries in {scan.elapsed*1e3:.1f} ms "
          f"with 4 threads")

    # 2. exploit: queries answered from the DB
    rep = Reports(catalog, stats)
    big = rep.find(f"type == file and size > 10k")
    print(f"\nrbh-find 'size > 10k': {len(big)} files")
    for p in big[:5]:
        print("  ", p)
    print("\nrbh-du projects/:",
          rep.du(os.path.join(root, "projects")))
    print("\ntop-3 largest files:")
    for row in rep.top_files(k=3):
        print(f"   {row['path']}  {int(row['size'])} bytes")
    uid = str(os.getuid())
    print(f"\nrbh-report -u {uid} (O(1), pre-aggregated):")
    print(rep.format_user_report(uid))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
