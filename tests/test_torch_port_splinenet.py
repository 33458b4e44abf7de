"""The port's SplineNet (sednet_tpu_torch.models.splinenet) against the JAX
package's flax module on the CPU, at full width (grid 20, k 10, N = 256),
on JAX-initialised variables carried across by
`weights.splinenet_from_variables`.

flax initialises BatchNorm to the identity (running mean 0, variance 1,
scale 1, bias 0), so the tests draw the BatchNorm scales, biases and
running statistics from a seed before carrying them across: the running
statistics then shape the output. Tolerances: the control grid at atol
1e-4 in eval mode and in train mode, the updated
running statistics at atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sednet_tpu.models.splinenet import SplineNet as JaxSplineNet
from sednet_tpu_torch.models import splinenet as tsn
from sednet_tpu_torch.models.init import init_like_flax
from sednet_tpu_torch.weights import splinenet_from_variables

N = 256


def flatten(tree, prefix=""):
    """A flax variable dict as flat "a/b/c" numpy arrays (writable copies),
    the keys of `sednet_tpu/train.py save_params_npz`."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.array(tree)}


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def seeded_variables(key: int, seed: int, grid_size: int = 20, k: int = 10):
    """JAX SplineNet variables from flax's init at PRNGKey(key), with the
    BatchNorm scales, biases and running statistics redrawn from `seed`.
    Returns the flat numpy dict."""
    net = JaxSplineNet(grid_size=grid_size, k=k)
    flat = flatten(net.init(jax.random.PRNGKey(key),
                            jnp.zeros((1, 32, 3), jnp.float32)))
    rng = np.random.RandomState(seed)
    for name in sorted(flat):
        shape = flat[name].shape
        if name.endswith("/mean"):
            flat[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
        elif name.endswith("/var"):
            flat[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif name.endswith("/scale"):
            flat[name] = rng.uniform(-1.5, 1.5, shape).astype(np.float32)
        elif "/bn" in name and name.endswith("/bias"):
            flat[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def variables():
    """The open and the closed spline's variables."""
    return {"open": seeded_variables(1, 11), "closed": seeded_variables(2, 12)}


def _patch(seed, n=N, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3) * np.array([1.0, 0.5, 0.05])
    w = rng.uniform(0.0, 1.0, (b, n))
    return x.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("which", ["open", "closed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_splinenet_matches_flax(variables, which, weighted):
    flat = variables[which]
    x, w = _patch(3 if which == "open" else 4)
    want = np.asarray(JaxSplineNet(20, 10).apply(
        unflatten(flat), jnp.asarray(x),
        weights=jnp.asarray(w) if weighted else None))
    model = splinenet_from_variables(flat, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    torch.from_numpy(w) if weighted else None).numpy()
    assert got.shape == (2, 400, 3) and want.shape == got.shape
    assert np.abs(got).max() <= 1.0 and np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_splinenet_train_mode_matches_flax(variables):
    """Batch statistics over (B, N, K) and (B, N), the biased variance, and
    the running statistics' update at momentum 0.99. B = 4: over B = 2 the
    (B, 1024) layers' statistics normalise each value to about +-1 whatever
    the two samples' gap, so a rounding-sized gap flips outputs."""
    flat = variables["open"]
    x, w = _patch(5, b=4)
    out, upd = JaxSplineNet(20, 10).apply(
        unflatten(flat), jnp.asarray(x), weights=jnp.asarray(w), train=True,
        mutable=["batch_stats"])
    model = splinenet_from_variables(flat, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(w),
                    train=True).numpy()
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-4)
    sd = model.state_dict()
    stats = flatten(upd["batch_stats"])
    assert len(stats) == 2 * 7
    for key, value in stats.items():
        np.testing.assert_allclose(sd[key.replace("/", ".")].numpy(), value,
                                   atol=1e-5)


def test_splinenet_builds_four_graphs_at_k10(monkeypatch, variables):
    calls = []
    real = tsn.knn_indices

    def counting(x, k):
        calls.append((tuple(x.shape), k))
        return real(x, k)

    monkeypatch.setattr(tsn, "knn_indices", counting)
    model = splinenet_from_variables(variables["closed"], device="cpu")
    with torch.no_grad():
        model(torch.from_numpy(_patch(6)[0]))
    assert calls == [((2, N, 3), 10), ((2, N, 64), 10), ((2, N, 64), 10),
                     ((2, N, 128), 10)]


def test_init_like_flax_and_strict_load(variables):
    model = init_like_flax(tsn.SplineNet(),
                           torch.Generator().manual_seed(0))
    for mod in model.modules():
        if isinstance(mod, tsn.BatchNorm):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
            assert torch.equal(mod.mean, torch.zeros_like(mod.mean))
            assert torch.equal(mod.var, torch.ones_like(mod.var))
    w = model.conv5.weight.detach()
    # lecun_normal: variance 1/fan_in, from a unit normal truncated at 2
    # (std 0.8796) and rescaled
    assert abs(float(w.var()) * 512 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.87962566 / 512 ** 0.5 + 1e-6
    assert torch.equal(model.conv8.bias, torch.zeros_like(model.conv8.bias))
    # the port's keys are flax's: the carried state dict round-trips
    flat = dict(variables["open"])
    jax_keys = {k.split("/", 1)[1].replace("/", ".").replace(
        ".kernel", ".weight").replace(".scale", ".weight") for k in flat}
    assert jax_keys == set(model.state_dict())
    del flat["batch_stats/conv3/bn/var"]
    with pytest.raises(RuntimeError, match="conv3.bn.var"):
        splinenet_from_variables(flat, device="cpu")
