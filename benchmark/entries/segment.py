"""Entry `segment`: `SegmentationModel.batch_segment` on float images, calls
back to back.

One caller, closed loop: each `step` segments the next `images_per_call`
images, channel `channel` of the pool's wells as float64 arrays (what a
notebook user passes), rotating through the pool, and returns when the
masks are back on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import manifest


class Entry:
    def __init__(self, config: dict, traffic: dict, pool: np.ndarray, device: torch.device,
                 workdir: Path):
        from arcadia_microscopy_tools_tpu_torch.models.segmentation import SegmentationModel

        self.params = config["segment"]
        self.model = SegmentationModel(checkpoint_path=manifest.REPO / config["weights"],
                                       device=device)
        self.images = [w[self.params["channel"]].astype(np.float64) for w in pool]
        self.per_call = traffic["images_per_call"]
        self.next = 0
        self.results: list[tuple[int, np.ndarray | None]] = []
        self.timings: dict[str, float] = {}
        # warm-up, on the images the window reaches last: the cell's one shape
        self._segment([(len(self.images) - 1 - k) % len(self.images) for k in range(self.per_call)])

    def _segment(self, ks: list[int]):
        return self.model.batch_segment(
            [self.images[k] for k in ks], cell_diameter_px=self.params["diameter"],
            flow_threshold=self.params["flow_threshold"],
            cellprob_threshold=self.params["cellprob_threshold"],
            num_iterations=self.params["niter"], batch_size=self.per_call, show_progress=False)

    def step(self) -> tuple[int, int]:
        """One call; returns (images sent, masks that came back)."""
        ks = [(self.next + i) % len(self.images) for i in range(self.per_call)]
        self.next = (self.next + self.per_call) % len(self.images)
        masks = self._segment(ks)
        self.results += list(zip(ks, masks))
        return len(ks), sum(m is not None for m in masks)

    def outputs(self):
        """(pool index, mask or None) of every image segmented."""
        return self.results

    def close(self) -> None:
        self.model = None
