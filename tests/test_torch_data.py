"""The port's synthetic data against the JAX package.

The port draws from ``torch.Generator``s, which cannot give
``jax.random``'s numbers, so the renderer is fed the reference's own
draws (``jax.random.split(key, 5)`` and the draws of ``_render_shapes``,
replicated here) and must give its images at 1e-6 (float32 exp, cos and
sin one ulp apart). The streams are held to their own contract: a pure
function of (seed, step), the reference's shapes, ranges and structure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import yolo_baf as jyolo
from repro.data import synthetic as jdata
from repro_torch.configs import yolo_baf as tyolo
from repro_torch.data import synthetic as tdata


def _reference_draws(cfg, seed, step):
    """The draws of ``repro.data.synthetic._render_shapes`` for batch
    ``step`` of stream ``seed``, as the port's ``ShapesDraws``."""
    b, s = cfg.batch_size, cfg.image_size
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k_lbl, k_pos, k_rad, k_noise, k_col = jax.random.split(key, 5)
    labels = jax.random.randint(k_lbl, (b,), 0, cfg.num_classes)
    cx = jax.random.uniform(k_pos, (b, 2), minval=0.3, maxval=0.7) * s
    radius = jax.random.uniform(k_rad, (b,), minval=0.15, maxval=0.3) * s
    colors = jax.random.uniform(k_col, (b, 3), minval=0.4, maxval=1.0)
    noise = jax.random.normal(k_noise, (b, s, s, 3))
    arrays = [np.array(a) for a in (labels, cx, radius, colors, noise)]
    return tdata.ShapesDraws(torch.from_numpy(arrays[0]).long(),
                             *(torch.from_numpy(a) for a in arrays[1:]))


@pytest.mark.parametrize("size,batch,classes", [(32, 4, 8), (64, 3, 5),
                                                (128, 2, 8)])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_render_matches_the_reference(size, batch, classes, seed, step):
    jcfg = jdata.ShapesDatasetConfig(image_size=size, num_classes=classes,
                                     batch_size=batch)
    want_img, want_lbl = next(jdata.shapes_batch_iterator(
        jcfg, seed=seed, start_step=step))
    draws = _reference_draws(jcfg, seed, step)
    got = tdata.render_shapes(draws, tdata.ShapesDatasetConfig(*jcfg))
    assert got.dtype == torch.float32 and got.shape == want_img.shape
    np.testing.assert_array_equal(draws.labels.numpy(), np.asarray(want_lbl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_img), rtol=1e-6,
                               atol=1e-6)


def test_shapes_stream_is_a_function_of_seed_and_step():
    cfg = tdata.ShapesDatasetConfig(image_size=32, batch_size=4)
    it = tdata.shapes_batch_iterator(cfg, seed=7, device="cpu")
    first = [next(it) for _ in range(3)]
    again = tdata.shapes_batch_iterator(cfg, seed=7, device="cpu")
    restart = tdata.shapes_batch_iterator(cfg, seed=7, start_step=2,
                                          device="cpu")
    other = next(tdata.shapes_batch_iterator(cfg, seed=8, device="cpu"))
    for (a, la), (b, lb) in zip(first, [next(again) for _ in range(3)]):
        assert torch.equal(a, b) and torch.equal(la, lb)
    img, lbl = next(restart)
    assert torch.equal(img, first[2][0]) and torch.equal(lbl, first[2][1])
    assert not torch.equal(first[0][0], first[1][0])
    assert not torch.equal(first[0][0], other[0])
    assert img.shape == (4, 32, 32, 3) and img.dtype == torch.float32
    assert lbl.dtype == torch.int64
    assert int(lbl.min()) >= 0 and int(lbl.max()) < cfg.num_classes


def test_draws_have_the_reference_ranges():
    cfg = tdata.ShapesDatasetConfig(image_size=64, batch_size=256)
    d = tdata.draw_shapes(cfg, torch.Generator().manual_seed(0))
    s = cfg.image_size
    assert d.labels.min() >= 0 and d.labels.max() < cfg.num_classes
    assert len(d.labels.unique()) == cfg.num_classes
    assert ((d.centres >= 0.3 * s) & (d.centres < 0.7 * s)).all()
    assert ((d.radii >= 0.15 * s) & (d.radii < 0.3 * s)).all()
    assert ((d.colours >= 0.4) & (d.colours < 1.0)).all()
    assert abs(float(d.noise.std()) - 1.0) < 0.01
    noiseless = tdata.render_shapes(d, cfg._replace(noise=0.0))
    peak = noiseless.amax(dim=(1, 2)) / d.colours
    assert (peak > 0.99).all() and (peak <= 1.0 + 1e-6).all()


def test_token_batches_match_the_reference_structure():
    cfg = tdata.TokenDatasetConfig(vocab_size=1000, seq_len=256,
                                   batch_size=6, copy_span=16,
                                   copy_prob=0.5)
    want = next(jdata.token_batch_iterator(jdata.TokenDatasetConfig(*cfg)))
    it = tdata.token_batch_iterator(cfg, seed=1, device="cpu")
    got = next(it)
    for k in ("tokens", "labels"):
        assert got[k].shape == want[k].shape
        assert got[k].dtype == torch.int32 and want[k].dtype == jnp.int32
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
    tok, lab = got["tokens"], got["labels"]
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    seq = torch.cat([tok, lab[:, -1:]], dim=1)
    band = seq // 256                               # one topic a sequence
    assert (band == band[:, :1]).all()
    copies = (seq[:, cfg.copy_span:] == seq[:, :-cfg.copy_span]).float()
    # x[t] copies base[t - span] with probability p from t >= span on, so
    # x[t] == x[t - span] with probability p + (1 - p) / 256 while t - span
    # is not itself a copy (t < 2 span), p ((1 - p) + p / 256) + (1 - p) /
    # 256 after
    p, n, span = cfg.copy_prob, cfg.seq_len + 1, cfg.copy_span
    chance = (1 - p) / 256
    expect = (span * (p + chance) + (n - 2 * span) * (
        p * (1 - p + p / 256) + chance)) / (n - span)
    assert abs(float(copies.mean()) - expect) < 0.05
    ref = np.concatenate([np.asarray(want["tokens"]),
                          np.asarray(want["labels"])[:, -1:]], 1)
    ref_copies = (ref[:, cfg.copy_span:] == ref[:, :-cfg.copy_span]).mean()
    assert abs(float(copies.mean()) - ref_copies) < 0.05
    again = next(tdata.token_batch_iterator(cfg, seed=1, device="cpu"))
    assert torch.equal(again["tokens"], tok)
    restart = next(tdata.token_batch_iterator(cfg, seed=1, start_step=1,
                                              device="cpu"))
    assert torch.equal(restart["tokens"], next(it)["tokens"])


def test_correlated_frames_drift_slowly():
    f = tdata.correlated_frames(6, image_size=32, seed=2)
    assert f.shape == (6, 32, 32, 3) and f.dtype == np.float32
    np.testing.assert_array_equal(f, tdata.correlated_frames(
        6, image_size=32, seed=2))
    ref = jdata.correlated_frames(6, image_size=32, seed=2)
    assert ref.shape == f.shape and ref.dtype == f.dtype
    step = np.abs(np.diff(f, axis=0)).mean()
    assert step < np.abs(f - f.mean()).mean()
    with pytest.raises(ValueError, match="one frame"):
        tdata.correlated_frames(0)


def test_host_shard_slice_splits_rows():
    batch = {"x": torch.arange(12).view(6, 2), "y": (np.arange(6),
                                                     torch.arange(6))}
    parts = [tdata.host_shard_slice(batch, i, 3) for i in range(3)]
    assert torch.equal(torch.cat([p["x"] for p in parts]), batch["x"])
    assert [p["y"][0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert isinstance(parts[0]["y"], tuple)
    want = jdata.host_shard_slice({"x": np.arange(12).reshape(6, 2)}, 1, 3)
    np.testing.assert_array_equal(parts[1]["x"].numpy(), want["x"])


def test_smoke_data_config_matches():
    assert tuple(tyolo.smoke_data_config()) == tuple(
        jyolo.smoke_data_config())
