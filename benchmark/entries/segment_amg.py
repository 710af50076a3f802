"""Entry `segment_amg`: `SegmentationModel.batch_segment` with Segment
Anything's automatic mask generator (`network="sam"`,
`return_candidates=True`) on 3-channel float images, calls back to back.

One caller, closed loop: each `step` segments the next `images_per_call`
images, the configuration's three channels of the pool's wells as float64
(C, H, W) arrays (what a notebook user passes), rotating through the pool,
and returns when the label images and the candidates are back on the host.
Set-up makes the benchmark's seeded weights (`sam_amg_weights.py`) and
writes them to the run's work directory as a torch state dict in SAM's
published layout, which the program loads as its checkpoint. After the
warm-up call the model's stage counters start again, so the span readers
see the window's calls alone (the warm-up builds the attention kernels).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import sam_amg_weights


class Entry:
    def __init__(self, config: dict, traffic: dict, pool: np.ndarray, device: torch.device,
                 workdir: Path):
        from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

        path = Path(workdir) / "sam_amg_seeded.pt"
        state = sam_amg_weights.seeded_state(config, pool, device)
        torch.save({k: v.cpu() for k, v in state.items()}, path)
        del state
        self.model = SegmentationModel(network="sam", checkpoint_path=path, device=device)
        self.images = [w[config["channels"]].astype(np.float64) for w in pool]
        self.per_call = traffic["images_per_call"]
        self.next = 0
        self.results: list[tuple[int, tuple | None]] = []
        self.timings: dict[str, float] = {}
        # warm-up, on the images the window reaches last: the cell's one shape
        self._segment([(len(self.images) - 1 - k) % len(self.images) for k in range(self.per_call)])
        self.model.stages.totals.clear()
        self.model.stages.counts.clear()

    def _segment(self, ks: list[int]):
        return self.model.batch_segment([self.images[k] for k in ks], batch_size=self.per_call,
                                        show_progress=False, return_candidates=True)

    def step(self) -> tuple[int, int]:
        """One call; returns (images sent, label images that came back)."""
        ks = [(self.next + i) % len(self.images) for i in range(self.per_call)]
        self.next = (self.next + self.per_call) % len(self.images)
        labels, candidates = self._segment(ks)
        self.results += [(k, None if m is None else (m, c))
                         for k, m, c in zip(ks, labels, candidates)]
        return len(ks), sum(m is not None for m in labels)

    def outputs(self):
        """(pool index, (labels, candidates) or None) of every image segmented."""
        return self.results

    def close(self) -> None:
        self.model = None
