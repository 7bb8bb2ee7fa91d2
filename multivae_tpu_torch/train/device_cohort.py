"""One split of one member's dataset on the member's device, scaled once.

The trainer's batches come from here (:func:`multivae_tpu_torch.train.
trainer.epoch_batches`, :func:`~multivae_tpu_torch.train.trainer.
test_batches`). :meth:`MultimodalDataset.gather
<multivae_tpu_torch.data.MultimodalDataset.gather>` reads a batch's rows
from the memmaps, scales them with the member's on-the-fly scalers and
builds its metadata on every call; a :class:`DeviceCohort` does the first
two once, for every row of the split, and keeps the result on the device.
A batch is then an ``index_select`` there. The host keeps what decides
the batches (the sampler, the presence of each modality), so the batches,
their groups and their order are the gathers'.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import profiling


class DeviceCohort:
    """Per modality one float32 ``[len(dataset), D]`` tensor on ``device``:
    row ``i`` is what ``dataset.gather`` returns for local index ``i``
    (cast to float32, then the on-the-fly transform, which is elementwise,
    so the bits are the gather's), zeros where the modality is absent (no
    batch reads those: a batch holds a modality only where every row has
    it). Built in one host-to-device copy per modality, counted as
    ``h2d_bytes``."""

    def __init__(self, dataset, device):
        self.dataset = dataset
        self.device = torch.device(device)
        n = len(dataset)
        true = (np.asarray(dataset.indices) if dataset.indices is not None
                else np.arange(n))
        self.present: Dict[str, np.ndarray] = {}
        self.tables: Dict[str, torch.Tensor] = {}
        for mod in dataset.modalities:
            present = dataset._present[mod][true]
            block = np.zeros((n, dataset.data[mod].shape[1]), np.float32)
            if present.any():
                rows = dataset._row_idx[mod][true[present]]
                block[present] = dataset._apply_otf(
                    mod, np.asarray(dataset.data[mod][rows],
                                    dtype=np.float32))
            self.present[mod] = present
            self.tables[mod] = profiling.to_device(torch.from_numpy(block),
                                                   self.device)

    def modalities_of(self, idxs) -> Tuple[str, ...]:
        """The modalities present in every row of the batch ``idxs``, in
        the dataset's order (those ``gather`` returns)."""
        return tuple(m for m, present in self.present.items()
                     if present[idxs].all())

    def gather_groups(self, groups: Sequence[Tuple[Sequence[str],
                                                   List[Sequence[int]]]]
                      ) -> List[Dict[str, torch.Tensor]]:
        """Each group ``(modalities, batches of equal rows)`` as ``{mod:
        [n_batches, rows, D]}`` on the device: the indices of every group
        go up in one copy (``h2d_bytes``), then one ``index_select`` per
        group and modality."""
        flat = [np.asarray(b, dtype=np.int64).reshape(-1)
                for _, batches in groups for b in batches]
        if not flat:
            return []
        index = profiling.to_device(torch.from_numpy(np.concatenate(flat)),
                                    self.device)
        out, off = [], 0
        for mods, batches in groups:
            n, rows = len(batches), len(batches[0])
            part = index[off:off + n * rows]
            off += n * rows
            out.append({m: self.tables[m].index_select(0, part).view(
                n, rows, -1) for m in mods})
        return out
