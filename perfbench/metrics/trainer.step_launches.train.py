"""Kernel launches per epoch in the traced window: the sum of the port's
``launches.<kernel>`` counts (``train.profiling.last_counts``; each ops
module's ``KERNEL_LAUNCHES``)."""


def read(view):
    epochs = view.counts.get("epochs")
    if view.trace is None or not epochs:
        return None
    from multivae_tpu_torch.train import profiling

    last = getattr(profiling, "last_counts", None)
    if last is None:
        return None
    n = sum(v for k, v in last().items() if k.startswith("launches."))
    return n / epochs if n else None
