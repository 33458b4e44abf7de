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
                 "sednet_tpu_torch.models.splinenet",
                 "sednet_tpu_torch.weights",
                 "sednet_tpu_torch.utils.torch_import",
                 "sednet_tpu_torch.utils.mesh",
                 "sednet_tpu_torch.losses.spline",
                 "sednet_tpu_torch.ops.chamfer",
                 "sednet_tpu_torch.splinenet_train",
                 "sednet_tpu_torch.export", "sednet_tpu_torch.serve",
                 "sednet_tpu_torch.parsenet_e2e",
                 "sednet_tpu_torch.utils.tracing",
                 "sednet_tpu_torch.models.parsenet",
                 "sednet_tpu_torch.ops.pointnet2",
                 "sednet_tpu_torch.losses.iou_loss",
                 "sednet_tpu_torch.postproc.inst_cluster",
                 "sednet_tpu_torch.gen_vis", "sednet_tpu_torch.utils.grid_vis",
                 "sednet_tpu_torch.cluster.baselines",
                 "sednet_tpu_torch.data.native",
                 "sednet_tpu_torch.ops.bf16_rule",
                 "sednet_tpu_torch.parallel",
                 "sednet_tpu_torch.parallel.mesh",
                 "sednet_tpu_torch.parallel.intra_shape",
                 "sednet_tpu_torch.parallel.big_forward",
                 "sednet_tpu_torch.parallel.dryrun"):
        assert name in MODULES
    # nor matplotlib or sklearn, which the grid renderer and the baselines
    # import when called (the card's machine has neither)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'sednet_tpu', 'orbax', "
              "'tensorstore', 'h5py', 'matplotlib', 'sklearn')]\n"
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


# The multi-device entry points run on the cards unless asked for the
# CPU: without CUDA they raise before starting a rank.
def test_mesh_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.predict import run_prediction
    from sednet_tpu_torch.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_prediction(Config(), mesh_devices=2, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(Config(mesh_shape=2, batch_size=2), run_dir=str(tmp_path))


# So do the parallel package's own: a mesh, its ranks and the dry run take
# the card unless given "cpu" (the dry run's CLI through --cpu).
def test_parallel_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from sednet_tpu_torch.parallel import dryrun, init_mesh, spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh(0, 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn("sednet_tpu_torch.parallel.dryrun:dryrun_rank", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    assert not os.listdir(tmp_path)


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


def test_serving_and_e2e_entry_points_default_to_the_card(monkeypatch,
                                                          tmp_path):
    """export, load_bundle, BundleServer and build_match_arrays run on the
    card unless given device="cpu": without one they raise."""
    import numpy as np

    from sednet_tpu_torch import export, serve
    from sednet_tpu_torch.config import Config
    from sednet_tpu_torch.parsenet_e2e import build_match_arrays
    from sednet_tpu_torch.train import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(Config(knn=4, embed=8))
    for call in (lambda: export.export_forward(model, 1, 16, 6),
                 lambda: export.load_bundle(str(tmp_path)),
                 lambda: serve.BundleServer(str(tmp_path)),
                 lambda: build_match_arrays(np.zeros(8, np.int64),
                                            np.ones(8, bool),
                                            np.zeros(8, np.int64),
                                            np.ones(8, np.int64))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
