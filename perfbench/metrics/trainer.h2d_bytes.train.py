"""Bytes per epoch the trainer copied from the host to the card in the
traced window (the port's ``h2d_bytes`` counter, read from
``train.profiling.last_counts``): batches, noise and test inputs."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    from multivae_tpu_torch.train import profiling

    last = getattr(profiling, "last_counts", None)
    n = last().get("h2d_bytes") if last is not None else None
    return n / epochs if n else None
