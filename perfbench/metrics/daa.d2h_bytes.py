"""Bytes per round the DAA fetched from the card in the traced window (the
port's ``d2h_bytes`` counter, read from ``train.profiling.last_counts``)."""


def read(view):
    rounds = view.counts.get("rounds")
    if view.trace is None or not rounds:
        return None
    from multivae_tpu_torch.train import profiling

    last = getattr(profiling, "last_counts", None)
    n = last().get("d2h_bytes") if last is not None else None
    return n / rounds if n else None
