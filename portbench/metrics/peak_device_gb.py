"""The most device memory the window's jobs held at once
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GB of 1e9 bytes; ``None`` off the card."""


def read(run):
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
