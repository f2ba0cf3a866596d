"""Serve batched requests while the policy engine tiers KV pages
HBM <-> host underneath (the paper's OST-watermark purge, adapted), on
the port.

The port of ``examples/serve_kv_tiering.py`` through ``repro_torch``:
each decode step's attention runs the ``paged_attention`` kernel on the
card. ``--device`` (default the card) is the serving engine's. The
weights are drawn from the device's ``torch.Generator`` (seed 0), not
JAX's PRNG, so the generated tokens are not the reference example's, and
the card's generator draws other weights than the CPU's.

    PYTHONPATH=src python examples/torch_serve_kv_tiering.py [--device cpu]
"""
import argparse

from repro_torch.serve.engine import PagedLMConfig, Request, ServingEngine


def main(device=None) -> None:
    cfg = PagedLMConfig(n_layers=2, n_pages=20, page_size=8,
                        high_wm=70.0, low_wm=40.0)
    engine = ServingEngine(cfg, seed=0, device=device)
    requests = [
        Request(req_id=i, prompt=[(13 * i + j) % cfg.vocab
                                  for j in range(10)], max_new=12)
        for i in range(5)
    ]
    print(f"serving {len(requests)} requests; hot pool = "
          f"{cfg.n_pages} pages x {cfg.page_size} tokens per layer")
    done = engine.run(requests, policy_interval=2)
    for r in done:
        print(f"  req{r.req_id}: generated {r.generated}")
    for li, rep in enumerate(engine.tier_report()):
        print(f"layer {li} tier report: {rep}")
    cache = engine.caches[0]
    print("\nper-sequence O(1) residency stats during run were available "
          "via cache.residency_report(seq_id) — pages now freed:",
          cache.tier_report())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
