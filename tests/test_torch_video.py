"""The port's video renderer against the JAX package's, and its APNG writer.

Both renderers are numpy over the same model constants, so the same physics
gives the same frames to the byte.
"""

import imageio.v3 as iio
import numpy as np
import pytest

from controllable_agent_tpu.envs import locomotion as jloco
from controllable_agent_tpu.envs import pointmass as jpm
from controllable_agent_tpu.train.video import Renderer as JaxRenderer
from controllable_agent_torch.envs import locomotion as tloco
from controllable_agent_torch.envs import pointmass as tpm
from controllable_agent_torch.train.video import Renderer, VideoRecorder, write_png


def _physics(ndof: int, rows: int = 12, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    q = rng.uniform(-1.0, 1.0, (rows, ndof))
    q[:, 0] *= 3.0
    q[:, 1] = rng.uniform(0.2, 1.6, rows)
    return np.concatenate([q, rng.randn(rows, ndof)], -1).astype(np.float32)


@pytest.mark.parametrize("domain", ["point_mass_maze", "walker", "cheetah", "hopper"])
def test_frames_equal_the_jax_renderer(domain) -> None:
    if domain == "point_mass_maze":
        jenv, tenv = jpm.PointMassMaze(), tpm.PointMassMaze()
        physics = np.random.RandomState(1).uniform(-0.3, 0.3, (12, 4)).astype(np.float32)
    else:
        task = "hopper_hop" if domain == "hopper" else f"{domain}_run"
        jenv, tenv = jloco.make(task), tloco.make(task)
        physics = _physics(tenv.model.ndof)
    ours, theirs = Renderer(domain, tenv), JaxRenderer(domain, jenv)
    for row in physics:
        got, want = ours(row), theirs(row)
        assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
        assert np.array_equal(got, want)
    assert not np.array_equal(ours(physics[0]), ours(physics[1]))


def test_png_round_trip(tmp_path) -> None:
    """The port's APNG encoder: a reader gives back every frame, to the byte,
    for a video of many frames and of one; a walker video compresses."""
    renderer = Renderer("walker", tloco.make("walker_walk"))
    frames = [renderer(row) for row in _physics(9, rows=7)]
    write_png(tmp_path / "v.png", frames, fps=20)
    back = iio.imread(tmp_path / "v.png", index=None)
    assert back.shape[0] == 7 and all(np.array_equal(b[..., :3], f) for b, f in zip(back, frames))
    assert (tmp_path / "v.png").stat().st_size < 7 * 256 * 256 // 10
    write_png(tmp_path / "one.png", frames[:1], fps=20)
    assert np.array_equal(iio.imread(tmp_path / "one.png", index=None)[0][..., :3], frames[0])
    recorder = VideoRecorder(tmp_path, renderer)
    recorder.record_trajectory(_physics(9, rows=3))
    assert recorder.save("40.mp4") == tmp_path / "eval_video" / "40.png"
    i = np.arange(300)
    many = np.stack([i % 256, i // 256, np.zeros_like(i)], -1).astype(np.uint8)[:, None]
    with pytest.raises(ValueError, match="colours"):
        write_png(tmp_path / "many.png", [many], fps=20)
