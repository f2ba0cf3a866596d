"""Every prompt token prefilled in the window over the window's seconds."""


def read(run):
    w = run.window
    return w.prompt_tokens / w.seconds if w.prefills else None
