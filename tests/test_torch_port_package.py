"""Package rules of the PyTorch port: it loads without JAX or the JAX
package, its entry points refuse to fall back to the CPU silently, and its
kernel build names the Hopper target."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import sednet_tpu_torch
from sednet_tpu_torch.ops import _build
from sednet_tpu_torch.predict import load_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every module of the package, the kernels' wrappers and the matrix-free
# spectral solver included
MODULES = ["sednet_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(sednet_tpu_torch.__path__,
                                          "sednet_tpu_torch."))


def test_import_loads_no_jax():
    for name in ("sednet_tpu_torch.cluster.spectral",
                 "sednet_tpu_torch.ops.cuda_kernels",
                 "sednet_tpu_torch.ops.graph", "sednet_tpu_torch.predict",
                 "sednet_tpu_torch.train", "sednet_tpu_torch.models.init",
                 "sednet_tpu_torch.losses.edge",
                 "sednet_tpu_torch.losses.embedding",
                 "sednet_tpu_torch.losses.type_loss",
                 "sednet_tpu_torch.fit.evaluation",
                 "sednet_tpu_torch.fit.arap",
                 "sednet_tpu_torch.models.splinenet"):
        assert name in MODULES
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'sednet_tpu')]\n"
              "assert not bad, bad\n"
              "import torch\n"
              "assert not torch.backends.cuda.matmul.allow_tf32\n"
              "assert not torch.backends.cudnn.allow_tf32\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sednet_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError):
        load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"))
    assert sednet_tpu_torch.resolve_device("cpu").type == "cpu"


def test_build_targets_sm90a_and_keys_on_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        assert (_build.CSRC / name).exists()
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "sednet_tpu_torch")
    assert len(_build._digest()) == 16


# A change to a header that the sources include (csrc/sim_tile.cuh) must
# give another build directory, or a stale library would be loaded.
def test_build_digest_covers_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    assert any(p.suffix == ".cuh" for p in csrc.iterdir())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest()
    header = csrc / "sim_tile.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert _build._digest() != before


def test_cpu_tensors_never_reach_the_launcher():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.require_cuda_f32("x", torch.zeros(3))
