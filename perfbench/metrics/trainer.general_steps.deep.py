"""Autograd general steps per epoch in the traced window (the port's
``trainer.general_steps`` counter, read from
``train.profiling.last_counts``): the batches that no step kernel took."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    from multivae_tpu_torch.train import profiling

    last = getattr(profiling, "last_counts", None)
    n = last().get("trainer.general_steps") if last is not None else None
    return n / epochs if n else None
