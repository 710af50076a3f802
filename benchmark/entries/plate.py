"""Entry `plate`: whole plates through `PlateRunner.run`, back to back.

One caller, closed loop: each `step` runs one plate of the traffic's wells
and returns when every table is back. The wells come from host memory
(`source: "memory"`, a mapping of well id to the pool's arrays) or from ND2
files that set-up writes from the pool into the run's work directory
(`source: "nd2"`, read by the port's `load_nd2` on the runner's prefetch
threads).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from benchmark import manifest
from benchmark import traffic as gen

ND2_CHANNELS = ["DAPI", "FITC", "TRITC", "CY5"]


class Entry:
    def __init__(self, config: dict, traffic: dict, pool: np.ndarray, device: torch.device,
                 workdir: Path):
        from arcadia_microscopy_tools_tpu_torch.core.microplate import MicroplateLayout, Well
        from arcadia_microscopy_tools_tpu_torch.parallel.plate import (
            DEFAULT_BATCH,
            PlateRunConfig,
            PlateRunner,
        )

        self.pool, self.device = pool, device
        self.plate_config = PlateRunConfig(**config["plate"])
        self.batch = self.plate_config.batch_size or DEFAULT_BATCH  # wells per dispatch
        weights = None
        if "weights" in config:  # the U-Net's, as numpy arrays under dotted keys
            with np.load(manifest.REPO / config["weights"]) as z:
                weights = {k: z[k] for k in z.files}
        self.runner = PlateRunner(self.plate_config, device=device, unet_params=weights)
        self.index = gen.pool_index(traffic)
        self.layout = MicroplateLayout([Well(id=w) for w in self.index])
        self.source = self._source(traffic["source"], Path(workdir))
        self.results: list[dict] = []  # one {well id: table or None} per plate
        self.timings: dict[str, float] = defaultdict(float)
        # warm-up: one batch of the cell's shape, which builds every kernel
        warm = MicroplateLayout([Well(id=w) for w in list(self.index)[: self.batch]])
        self.runner.run(warm, self.source)

    def _source(self, kind: str, workdir: Path):
        ids = list(self.index)
        if kind == "memory":
            return {w: self.pool[self.index[w]] for w in ids}
        if kind == "nd2":
            from arcadia_microscopy_tools_tpu_torch import _native
            from arcadia_microscopy_tools_tpu_torch.io.nikon import load_nd2

            from benchmark.nd2_writer import write_nd2

            _native.build()  # the port's C++ planarize, built once per checkout
            files = [write_nd2(workdir / f"pool{k:02d}.nd2", well, channel_names=ND2_CHANNELS)
                     for k, well in enumerate(self.pool)]
            paths = {w: files[self.index[w]] for w in ids}
            return lambda w: load_nd2(paths[w])[0]
        raise ValueError(f"unknown well source {kind!r}")

    def step(self) -> tuple[int, int]:
        """One plate; returns (wells attempted, wells whose table came back)."""
        res = self.runner.run(self.layout, self.source)
        for k, v in res.timings.items():
            self.timings[k] += v
        self.results.append(res.tables)
        return len(res.tables), sum(t is not None for t in res.tables.values())

    def outputs(self):
        """(pool index, table or None) of every well of every plate run."""
        return [(self.index[w], t) for tables in self.results for w, t in tables.items()]

    def staged_batch(self) -> torch.Tensor:
        """The window's first batch as the runner stages it: (B, C, H, W)
        uint16 on the device."""
        ids = list(self.index)[: self.batch]
        return torch.from_numpy(np.stack([self.pool[self.index[w]] for w in ids])).to(self.device)

    def close(self) -> None:
        self.runner = None
