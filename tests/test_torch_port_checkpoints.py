"""The port's checkpoint formats (sednet_tpu_torch.weights.load_params,
utils/torch_import.py, train.load_optimizer_state) against the JAX
package's readers on the CPU, on a small SEDNet (emb 16, k 8, N 64).

The reference-layout `.pth` files are written from JAX parameters through
JAX's own inverse, `flax_params_to_torch_state_dict`, and the orbax
directories by orbax on JAX's side; the port reads both without JAX.
Tolerances: every leaf exactly equal to JAX's `load_params`; forwards at
atol 1e-4; parameters one Adam step after the resume at rtol 1e-5 (and 1e-5 of the
step's size, lr, for elements near 0)."""
import functools
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import sednet_tpu.config as jcfg
import sednet_tpu.train as jtrain
import sednet_tpu_torch.config as pcfg
import sednet_tpu_torch.data as data_port
import sednet_tpu_torch.predict as predict_port
import sednet_tpu_torch.train as ptrain
from sednet_tpu.models import SEDNet as JaxSEDNet
from sednet_tpu.utils.torch_import import flax_params_to_torch_state_dict
from sednet_tpu_torch.utils import torch_import as ti
from sednet_tpu_torch.weights import (flatten_tree, load_checkpoint,
                                      load_params, params_from_flat,
                                      read_orbax_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(embed=16, knn=8)


@functools.lru_cache(maxsize=None)
def _init(embed, k):
    model = JaxSEDNet(emb_size=embed, num_primitives=6, mode=5, k=k)
    return model, jax.jit(model.init)


def jax_params(embed=16, k=8, seed=0):
    model, init = _init(embed, k)
    x = jnp.zeros((1, 64, 6), jnp.float32)
    return model, jax.device_get(init(jax.random.PRNGKey(seed), x)["params"])


def as_port(tree) -> dict:
    """A JAX parameter tree in the port's state-dict names (exact copy)."""
    return params_from_flat(flatten_tree(tree), "")


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def small():
    model, params = jax_params()
    x = np.random.RandomState(0).randn(1, 64, 6).astype(np.float32)
    return model, params, x


def write_pth(path, params, how):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in flax_params_to_torch_state_dict(params).items()}
    if how == "module":
        sd = {"module." + k: v for k, v in sd.items()}
    elif how in ("state_dict", "model_state"):
        sd = {how: sd, "epoch": 3}
    torch.save(sd, path)
    return path


# The four layouts of a reference checkpoint: the port reads the leaves
# JAX's load_params reads, bit for bit, and its forward is JAX's.
@pytest.mark.parametrize("how", ["plain", "module", "state_dict",
                                 "model_state"])
def test_pth_matches_jax_load_params(small, tmp_path, how):
    model, params, x = small
    path = write_pth(str(tmp_path / "w.pth"), params, how)
    want = jtrain.load_params(path)
    assert_same(load_params(path), as_port(want))
    assert_same(ti.load_torch_checkpoint(path), as_port(params))
    port = load_checkpoint(path, pcfg.Config(**SMALL), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    out = jax.jit(model.apply)({"params": want}, jnp.asarray(x))
    for field in ("embedding", "type_log_prob", "edge_logits"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(out, field)),
                                   atol=1e-4, err_msg=field)


def test_pth_round_trip_and_reference_names(small):
    _, params, _ = small
    port = as_port(params)
    sd = ti.params_to_torch_state_dict(port)
    ref = flax_params_to_torch_state_dict(params)
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k], torch.from_numpy(np.asarray(ref[k]))), k
    assert_same(ti.torch_state_dict_to_params(sd), port)


def test_pth_unknown_keys_are_logged_and_missing_keys_raise(small, caplog):
    _, params, _ = small
    sd = {"module." + k: torch.from_numpy(np.array(v))
          for k, v in flax_params_to_torch_state_dict(params).items()}
    # reference-only buffers the importer drops, and a duplicate
    # registration of encoder.bn1 through the Sequential
    sd["module.encoder.bn4.weight"] = torch.zeros(256)
    sd["module.encoder.conv1.1.weight"] = sd["module.encoder.bn1.weight"]
    with caplog.at_level(logging.WARNING, "sednet_tpu_torch.torch_import"):
        got = ti.torch_state_dict_to_params(sd)
    assert_same(got, as_port(params))
    assert "encoder.bn4.weight" in caplog.text
    assert "encoder.conv1.1.weight" in caplog.text
    # this model has no normal head, so strict misses its first key
    with pytest.raises(KeyError, match="normal_predict_mlps.0.weight"):
        ti.torch_state_dict_to_params(sd, strict=True)
    head = {"normal_predict_mlps.0.weight": torch.zeros(3, 256, 1),
            "normal_predict_mlps.0.bias": torch.zeros(3),
            "normal_predict_mlps.1.weight": torch.ones(3),
            "normal_predict_mlps.1.bias": torch.zeros(3),
            "normal_predict_mlps.2.weight": torch.zeros(3, 3, 1),
            "normal_predict_mlps.2.bias": torch.zeros(3)}
    sd.update(head)
    got = ti.torch_state_dict_to_params(sd, strict=True)
    assert got["normal_conv1.weight"].shape == (3, 256)
    assert got["normal_gn.weight"].shape == (3,)
    del sd["module.bn1.bias"]
    with pytest.raises(KeyError, match="bn1.bias"):
        ti.torch_state_dict_to_params(sd, strict=True)
    assert "gn1.bias" not in ti.torch_state_dict_to_params(sd)


# orbax directories as JAX saves them, bare and under "params": the same
# arrays, read without JAX.
@pytest.mark.parametrize("wrapped", [False, True])
def test_orbax_matches_jax_load_params(small, tmp_path, wrapped):
    _, params, _ = small
    path = str(tmp_path / "ckpt")
    ocp.PyTreeCheckpointer().save(path, {"params": params} if wrapped
                                  else params)
    want = jtrain.load_params(path)
    if wrapped:
        assert set(want) == {"params"}
        want = want["params"]
    assert_same(load_params(path), as_port(want))
    assert_same(load_params(path), as_port(params))
    tree = read_orbax_tree(path)
    flat = flatten_tree(tree["params"] if wrapped else tree)
    assert all(isinstance(v, np.ndarray) for v in flat.values())


def test_orbax_read_loads_no_jax(small, tmp_path):
    _, params, _ = small
    path = str(tmp_path / "ckpt")
    ocp.PyTreeCheckpointer().save(path, params)
    code = ("import sys\n"
            "from sednet_tpu_torch.weights import load_params\n"
            f"sd = load_params({path!r})\n"
            "assert len(sd) == 45, len(sd)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'orbax', 'sednet_tpu')]\n"
            "assert not bad, bad\n"
            "assert 'tensorstore' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_orbax_without_tensorstore_raises(small, tmp_path, monkeypatch):
    _, params, _ = small
    path = str(tmp_path / "ckpt")
    ocp.PyTreeCheckpointer().save(path, params)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="orbax checkpoint directory"):
        load_params(path)


def test_orbax_other_layout_raises(tmp_path):
    import json

    (tmp_path / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": False, "use_zarr3": False}))
    with pytest.raises(ValueError, match="without OCDBT"):
        read_orbax_tree(str(tmp_path))


# --- the optimizer's resume ---------------------------------------------------

def _grads(params, step):
    rng = np.random.RandomState(100 + step)
    return {k: rng.randn(*np.shape(v)).astype(np.float32)
            for k, v in sorted(flatten_tree(params).items())}


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


# Two JAX AdamW steps, the optax state saved by orbax (with the clip's
# chain and without), then one more step on each side from the same
# parameters, the same gradients and a new learning rate: the port's
# parameters equal JAX's.
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_optimizer_resumes_jax_orbax_state(small, tmp_path, grad_clip):
    _, params, _ = small
    kw = dict(**SMALL, weight_decay=0.01, grad_clip=grad_clip)
    opt = jtrain.make_optimizer(jcfg.Config(lr=1e-3, **kw))
    state = opt.init(params)

    @jax.jit
    def step_fn(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for step in range(2):
        params, state = jax.device_get(step_fn(
            _unflatten(_grads(params, step)), state, params))
    opt_dir, params_dir = str(tmp_path / "latest_opt"), str(tmp_path / "p")
    ocp.PyTreeCheckpointer().save(opt_dir, jax.device_get(state))
    ocp.PyTreeCheckpointer().save(params_dir, params)
    state = jtrain.set_learning_rate(state, 2e-3)
    want = as_port(jax.device_get(step_fn(_unflatten(_grads(params, 2)),
                                          state, params)[0]))

    cfg = pcfg.Config(lr=2e-3, preload_model=True,
                      pretrain_model_path=params_dir,
                      pretrain_opti_path=opt_dir, **kw)
    model, optimizer, _ = ptrain.init_training(cfg, "cpu")
    assert_same(model.state_dict(), as_port(params))
    for group in optimizer.param_groups:
        assert group["lr"] == 2e-3
        assert group["weight_decay"] == pytest.approx(0.01)
    st = optimizer.state_dict()["state"]
    assert {float(s["step"]) for s in st.values()} == {2.0}
    grads = params_from_flat(_grads(params, 2), "")
    for name, p in model.named_parameters():
        p.grad = grads[name].clone()
    if grad_clip > 0:
        ptrain.clip_by_global_norm(list(model.parameters()), grad_clip)
    optimizer.step()
    got = model.state_dict()
    # each side rounds the step (about lr in size) in its own order, so an
    # element that the three steps bring near 0 is held to 1e-5 of lr
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5 * cfg.lr, err_msg=k)


def test_optimizer_state_names_a_mismatch(small, tmp_path):
    _, params, _ = small
    opt = jtrain.make_optimizer(jcfg.Config(optim="adam", **SMALL))
    path = str(tmp_path / "latest_opt")
    ocp.PyTreeCheckpointer().save(path, jax.device_get(opt.init(params)))
    model = ptrain.build_model(pcfg.Config(**SMALL))
    adamw = ptrain.make_optimizer(pcfg.Config(**SMALL), model.parameters())
    with pytest.raises(ValueError, match="AdamW"):
        ptrain.load_optimizer_state(adamw, path, model)
    with pytest.raises(ValueError, match="pass the model"):
        ptrain.load_optimizer_state(adamw, path)
    adam = ptrain.make_optimizer(pcfg.Config(optim="adam", **SMALL),
                                 model.parameters())
    ptrain.load_optimizer_state(adam, path, model)
    for kw, error, match in (({"embed": 24}, ValueError, "mlp_seg_prob2"),
                             ({"edge_module": False}, KeyError, "edge_conv1")):
        other = ptrain.build_model(pcfg.Config(**{**SMALL, **kw}))
        adam = ptrain.make_optimizer(pcfg.Config(optim="adam"),
                                     other.parameters())
        with pytest.raises(error, match=match):
            ptrain.load_optimizer_state(adam, path, other)


# --- run_prediction on each format --------------------------------------------

N_TINY = 128   # configs/config_test_tiny.yml: 128 points, embed 32, k 8


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Two test shapes of N_TINY points and the type and inst models'
    checkpoints in the three formats."""
    root = str(tmp_path_factory.mktemp("tiny"))
    data_port.write_parsenet_h5(root, n_shapes=2, n_points=N_TINY, seed=0)
    paths = {}
    for name, seed in (("type", 1), ("inst", 2)):
        _, params = jax_params(embed=32, seed=seed)
        base = os.path.join(root, name)
        jtrain.save_params_npz(base + ".npz", params)
        ocp.PyTreeCheckpointer().save(base + "_orbax", {"params": params})
        write_pth(base + ".pth", params, "module")
        paths[name] = {"npz": base + ".npz", "orbax": base + "_orbax",
                       "pth": base + ".pth"}
    return root, paths


@pytest.mark.parametrize("fmt", ["orbax", "pth"])
def test_run_prediction_reads_each_format(tiny, fmt):
    root, paths = tiny

    def run(f):
        cfg = pcfg.Config(num_points=N_TINY, knn=8, embed=32,
                          hpnet_embed=False, num_test=2,
                          pretrain_model_path=paths["type"][f],
                          pretrain_model_type_path=paths["inst"][f])
        return predict_port.run_prediction(cfg, data_root=root, batch_size=2,
                                           save_viz=False, device="cpu")

    (want_sum, want), (got_sum, got) = run("npz"), run(fmt)
    assert got_sum == want_sum and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
