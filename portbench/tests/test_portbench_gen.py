"""The frozen generator and the train feed's plain copy."""
import numpy as np

from portbench import gen


def test_pool_is_deterministic_per_seed():
    a = gen.make_pool(2 ** 31 + 7, 3, 300, (3, 20), edges=True)
    b = gen.make_pool(2 ** 31 + 7, 3, 300, (3, 20), edges=True)
    c = gen.make_pool(2 ** 31 + 8, 3, 300, (3, 20), edges=True)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["points"], c[0]["points"])


def test_clouds_follow_the_traffic():
    pool = gen.make_pool(11, 12, 400, (3, 20), edges=True)
    ks = [len(np.unique(c["labels"])) for c in pool]
    # every seed gets the same segment counts, in its own order
    assert sorted(ks) == gen.segment_counts(12, (3, 20))
    assert min(ks) == 3 and max(ks) == 20 - 1
    other = [len(np.unique(c["labels"])) for c in gen.make_pool(12, 12, 400, (3, 20))]
    assert sorted(other) == sorted(ks) and other != ks
    for c in pool:
        assert c["points"].dtype == np.float32 and c["points"].shape == (400, 3)
        # centred, scaled to a unit extent, then rotated: the smallest
        # principal axis is x
        assert np.abs(c["points"].mean(0)).max() < 1e-5
        cov = c["points"].T.astype(np.float64) @ c["points"]
        assert np.argmax(np.abs(np.linalg.eigh(cov)[1][:, 0])) == 0
        assert np.allclose(np.linalg.norm(c["normals"], axis=1), 1.0, atol=1e-5)
        assert set(np.unique(c["prim"])) <= set(gen.TYPES)
        assert 0 < c["edges"].sum() < 400


def test_eval_batches_draw_distinct_clouds_in_a_seeded_order():
    pool = gen.make_pool(3, 6, 64, (3, 5))
    a = [b["points"] for _, b in zip(range(4), gen.eval_batches(5, pool, 3))]
    b = [b["points"] for _, b in zip(range(4), gen.eval_batches(5, pool, 3))]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (3, 64, 3)
    # an epoch is two batches: together they hold all six clouds
    assert len({x.tobytes() for x in np.concatenate(a[:2])}) == 6


def test_feed_copy_gives_the_ports_batches():
    from sednet_tpu_torch.data.datasets import BatchLoader, _H5Dataset

    pool = gen.make_pool(9, 5, 256, (3, 8), edges=True, prepare=dict)
    arr = gen.stack(pool, ("points", "normals", "labels", "prim", "edges",
                           "edges_w"))
    ds = _H5Dataset(arr["points"], arr["labels"], arr["normals"], arr["prim"],
                    arr["edges"], arr["edges_w"], train=True, augment=True,
                    num_points=256, max_segments=50, seed=21)
    loader = BatchLoader(ds, 2, shuffle=True, seed=22)
    port = [b for _ in range(2) for b in loader]
    mine = gen.feed_batches(pool, 2, 22, 21, 50)
    for p in port:
        m = next(mine)
        for k in p:
            assert np.array_equal(p[k], m[k]), k
