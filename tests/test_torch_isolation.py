"""The PyTorch port stands alone: it imports neither JAX, orbax nor the JAX
package, and never mentions them in an import statement; nor does
`chip_smoke.py` with every port module it drives. The subprocess also reads
a LIF container and takes one training step with JAX blocked."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "arcadia_microscopy_tools_tpu_torch"

_BLOCKER = """
import sys
for name in ("jax", "jaxlib", "orbax", "arcadia_microscopy_tools_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import arcadia_microscopy_tools_tpu_torch
import arcadia_microscopy_tools_tpu_torch.ops.cc_cuda
import arcadia_microscopy_tools_tpu_torch.ops.segment_reduce
import arcadia_microscopy_tools_tpu_torch.ops.basic
import arcadia_microscopy_tools_tpu_torch.ops.filters
import arcadia_microscopy_tools_tpu_torch.ops.morphology
import arcadia_microscopy_tools_tpu_torch.ops.pipeline
import arcadia_microscopy_tools_tpu_torch.ops.rank_cuda
import arcadia_microscopy_tools_tpu_torch.ops.stats
import arcadia_microscopy_tools_tpu_torch.ops.threshold
import arcadia_microscopy_tools_tpu_torch.operations
import arcadia_microscopy_tools_tpu_torch.pipeline
import arcadia_microscopy_tools_tpu_torch._build
import arcadia_microscopy_tools_tpu_torch.model
import arcadia_microscopy_tools_tpu_torch.models.segmentation
import arcadia_microscopy_tools_tpu_torch.models.weights
import arcadia_microscopy_tools_tpu_torch.testing
import arcadia_microscopy_tools_tpu_torch.typing
import arcadia_microscopy_tools_tpu_torch.utils
import arcadia_microscopy_tools_tpu_torch._native
import arcadia_microscopy_tools_tpu_torch.core
import arcadia_microscopy_tools_tpu_torch.core.metadata_structures
import arcadia_microscopy_tools_tpu_torch.core.microscopy
import arcadia_microscopy_tools_tpu_torch.io
import arcadia_microscopy_tools_tpu_torch.io.nd2
import arcadia_microscopy_tools_tpu_torch.io.nikon
import arcadia_microscopy_tools_tpu_torch.io.tiles
import arcadia_microscopy_tools_tpu_torch.io.lif
import arcadia_microscopy_tools_tpu_torch.io.leica
import arcadia_microscopy_tools_tpu_torch.leica
import arcadia_microscopy_tools_tpu_torch.models.train
import arcadia_microscopy_tools_tpu_torch.channels
import arcadia_microscopy_tools_tpu_torch.metadata_structures
import arcadia_microscopy_tools_tpu_torch.microplate
import arcadia_microscopy_tools_tpu_torch.microscopy
import arcadia_microscopy_tools_tpu_torch.nikon
import arcadia_microscopy_tools_tpu_torch.models.flows
import arcadia_microscopy_tools_tpu_torch.models.unet_s2d
import arcadia_microscopy_tools_tpu_torch.parallel.plate
import arcadia_microscopy_tools_tpu_torch.parallel.mesh
import arcadia_microscopy_tools_tpu_torch.parallel.collectives
import arcadia_microscopy_tools_tpu_torch.parallel.multiprocess
import arcadia_microscopy_tools_tpu_torch.ops
import arcadia_microscopy_tools_tpu_torch.masks
import arcadia_microscopy_tools_tpu_torch.measure
import arcadia_microscopy_tools_tpu_torch.blending
import arcadia_microscopy_tools_tpu_torch.viz
import arcadia_microscopy_tools_tpu_torch.viz.blending
import arcadia_microscopy_tools_tpu_torch.utils.profiling
import arcadia_microscopy_tools_tpu_torch.models
import arcadia_microscopy_tools_tpu_torch.models.synthetic
arcadia_microscopy_tools_tpu_torch.models.synthetic.load_fixture_stats()
import arcadia_microscopy_tools_tpu_torch.models.sam_amg
import arcadia_microscopy_tools_tpu_torch.models.sam_decoder
from arcadia_microscopy_tools_tpu_torch import MicroscopyImage
image = MicroscopyImage.from_nd2_path("tests/data/example-multichannel.nd2")
image.device_intensities("cpu")
import contextlib, io, tempfile
sys.path.insert(0, "tests")
from lif_builder import simple_confocal_lif
with tempfile.TemporaryDirectory() as tmp:
    simple_confocal_lif(tmp + "/a.lif", name="S1", shape=(32, 32))
    MicroscopyImage.from_lif_path(tmp + "/a.lif", "S1").device_intensities("cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        arcadia_microscopy_tools_tpu_torch.models.train.train(
            steps=1, batch=1, size=64, out=tmp + "/w.npz", device="cpu")
import chip_smoke
chip_smoke.port_modules()
arcadia_microscopy_tools_tpu_torch.models.weights.load_weights()
leaked = [
    m for m, mod in sys.modules.items()
    if mod is not None and m.startswith(("jax", "orbax", "arcadia_microscopy_tools_tpu."))
]
assert not leaked, leaked
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_import_mentions_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|orbax|arcadia_microscopy_tools_tpu)\b(?!_torch)", re.M
    )
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
