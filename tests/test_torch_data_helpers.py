"""The port's ``drop_unobserved``, ``unpack_scene`` and ``batch_iterator``
against the JAX package's on seeded numpy scenes, bit for bit (both are
numpy), and the port's ``data`` package exports the JAX package's names."""

import contextlib

import numpy as np
import pytest

import trajnetplusplusbaselines_tpu.data as jdata
import trajnetplusplusbaselines_torch.data as data


def _scenes(seed, agents, t=21, gaps=True):
    """NaN-padded ``[t, a, 2]`` scenes: random walks whose neighbours appear
    late or leave early."""
    rng = np.random.default_rng(seed)
    scenes = []
    for a in agents:
        xy = rng.normal(size=(t, a, 2)).cumsum(axis=0) * 0.3
        for p in range(1, a if gaps else 1):
            first, last = sorted(rng.integers(0, t, size=2))
            xy[:first, p] = np.nan
            xy[last + 1:, p] = np.nan
        scenes.append(xy)
    return scenes


def test_data_exports_the_jax_names():
    assert sorted(set(jdata.__all__) - {"batching"}) == sorted(set(data.__all__) - {"batching"})


@pytest.mark.parametrize("obs_length", [9, 5])
def test_drop_unobserved_matches_jax(obs_length):
    for xy in _scenes(0, [1, 3, 6, 9, 12]):
        got, got_mask = data.drop_unobserved(xy, obs_length)
        want, want_mask = jdata.drop_unobserved(xy, obs_length)
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_array_equal(got, want)


def test_drop_unobserved_keeps_the_primary_alone():
    """Every neighbour absent at frame 8 (the last observed): only the
    primary is left, as in JAX."""
    xy = _scenes(1, [5], gaps=False)[0]
    xy[8, 1:] = np.nan
    got, mask = data.drop_unobserved(xy)
    want, want_mask = jdata.drop_unobserved(xy)
    assert mask.tolist() == [True, False, False, False, False]
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (21, 1, 2)


@pytest.mark.parametrize("bucket", [None, 4])
def test_unpack_scene_round_trips_pack_scenes(bucket):
    """``unpack_scene`` of ``pack_scenes`` gives back each scene (its first
    ``bucket`` agents where a bucket truncates), equal to JAX's."""
    scenes = _scenes(2, [2, 7, 4, 1, 5])
    truncating = pytest.warns(UserWarning, match="truncating")
    with truncating if bucket else contextlib.nullcontext():
        packed = data.pack_scenes(scenes, bucket=bucket, pad_scenes_to=6)
    with truncating if bucket else contextlib.nullcontext():
        jpacked = jdata.pack_scenes(scenes, bucket=bucket, pad_scenes_to=6)
    for i, scene in enumerate(scenes):
        got = data.unpack_scene(packed, i)
        np.testing.assert_array_equal(got, jdata.unpack_scene(jpacked, i))
        np.testing.assert_array_equal(got, scene[:, :bucket].astype(np.float32))
    assert data.unpack_scene(packed, 5).shape == (21, 0, 2)  # a padding scene


@pytest.mark.parametrize("with_goals", [False, True])
def test_batch_iterator_matches_jax(with_goals):
    """Batches of 3 over 7 scenes: the last holds one scene and two padding
    scenes, fully masked, as JAX pads it."""
    scenes = _scenes(3, [3, 2, 9, 4, 1, 6, 5])
    rng = np.random.default_rng(4)
    goals = [rng.normal(size=(s.shape[1], 2)) for s in scenes] if with_goals else None
    got = list(data.batch_iterator(scenes, goals, 3))
    want = list(jdata.batch_iterator(scenes, goals, 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.num_scenes == 3
        for field in data.PackedScenes._fields:
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert getattr(g, field).dtype == getattr(w, field).dtype
    last = got[-1]
    assert not last.mask[:, 1:].any() and (last.num_agents[1:] == 0).all()
    assert not last.xy[:, 1:].any() and not last.goals[1:].any()
