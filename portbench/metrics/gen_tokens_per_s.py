"""Every token delivered in the window (each prefill's first tokens too)
over the window's seconds, prefills included."""


def read(run):
    w = run.window
    return w.gen_tokens / w.seconds if w.steps else None
