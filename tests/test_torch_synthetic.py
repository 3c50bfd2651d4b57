"""data/synthetic.py against the JAX package's copy: every scene and both
make_video modes, several seeds and sizes, the same arrays bit for bit."""

import numpy as np
import pytest

from ntm_tracker_tpu.data import synthetic as jsyn
from ntm_tracker_tpu_torch.data import synthetic as tsyn


def test_scene_names_match():
    assert tsyn.SCENES == jsyn.SCENES == ("smooth", "scale", "fast", "texture")


@pytest.mark.parametrize("scene", jsyn.SCENES)
@pytest.mark.parametrize("seed,n,hw", [(0, 8, (180, 320)), (7, 5, (90, 160)), (1234, 24, (64, 96))])
def test_make_scene_bit_for_bit(scene, seed, n, hw):
    jf, jb = jsyn.make_scene(np.random.RandomState(seed), n, scene, hw)
    tf, tb = tsyn.make_scene(np.random.RandomState(seed), n, scene, hw)
    assert tf.dtype == jf.dtype == np.float32 and tb.dtype == jb.dtype == np.float32
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("velocity,scale_walk", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_make_video_bit_for_bit(velocity, scale_walk, seed):
    jrs, trs = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):  # the generator's state after one clip carries into the next
        jf, jb = jsyn.make_video(jrs, 6, (72, 128), velocity=velocity, scale_walk=scale_walk)
        tf, tb = tsyn.make_video(trs, 6, (72, 128), velocity=velocity, scale_walk=scale_walk)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tb, jb)


def test_unknown_scene_raises():
    with pytest.raises(ValueError):
        tsyn.make_scene(np.random.RandomState(0), 3, "nope")
