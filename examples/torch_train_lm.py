"""End-to-end training on the PyTorch port: train an LM for a few
hundred steps with the full stack (data pipeline, AdamW, Robinhood-managed
checkpoints, restart-capable loop).

The port of ``examples/train_lm.py`` through ``repro_torch``: the same
presets run ``repro_torch.launch.train`` with the same arguments, plus
``--device`` (default the card). Default preset is small (~3M params, 200
steps). The ``100m`` preset instantiates a ~100M-param gemma2-family
model. ``main`` returns what ``launch.train.main`` returns: the final
state, the loss history, the restarts and the checkpoint manager.

    PYTHONPATH=src python examples/torch_train_lm.py [--preset small|100m]
        [--steps N] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=["small", "100m"])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=device,
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_train_")
    if args.preset == "small":
        steps = args.steps or 200
        argv = ["--arch", "chatglm3-6b", "--smoke", "--steps", str(steps),
                "--batch", "8", "--seq", "64", "--lr", "3e-3",
                "--ckpt-dir", ckpt, "--ckpt-interval", "50"]
    else:
        # ~100M params: gemma2-family, 12 layers, d_model 512
        import dataclasses
        from repro_torch.configs import gemma2_9b
        cfg = dataclasses.replace(
            gemma2_9b.SMOKE, name="gemma2_100m", n_layers=12, d_model=512,
            n_heads=8, n_kv=4, head_dim=64, d_ff=2048, vocab=32768,
            window=256)
        gemma2_9b.SMOKE = cfg  # install the preset
        steps = args.steps or 300
        argv = ["--arch", "gemma2-9b", "--smoke", "--steps", str(steps),
                "--batch", "8", "--seq", "256", "--lr", "1e-3",
                "--ckpt-dir", ckpt, "--ckpt-interval", "100"]
    if args.device is not None:
        argv += ["--device", str(args.device)]
    return train_mod.main(argv)


if __name__ == "__main__":
    main()
