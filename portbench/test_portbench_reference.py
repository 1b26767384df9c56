"""The plain reference against the port's CPU path at smoke width, on the
same seeded weights and frames: the edge, eq. 4 and the container bytes,
unpacking, the BaF restore with eq. 6, and the cloud's logits."""
import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import model as ref
from portbench.reference import wire

CPU = torch.device("cpu")
CNN_BAF = spec.family("cnn_baf")


def assert_close(got, want):
    """Within 1e-5 of the tensor's largest magnitude: float32 sums of up to
    1152 products a layer, taken in another order by the reference (NCHW
    against the port's channels-last view), differ by a few ulps of the
    layer's scale, not of each element."""
    gap = float((got - want).abs().max())
    assert gap <= 1e-5 * float(want.abs().max()), gap


def _setup(config_name, backend="raw"):
    cfg = CNN_BAF.smoke_config(spec.config(config_name))
    traffic = {"kind": "cloud_closed_loop", "backend": backend, "pool": 3}
    inp = CNN_BAF.make_inputs(cfg, traffic, 2**31 + 7, CPU)
    prog = CNN_BAF.build(cfg, traffic, inp, CPU)
    return cfg, inp.weights, inp.frames, inp.sel, prog


@pytest.mark.parametrize("config_name", ["yolo3-baf-c64", "yolo3-baf-c96"])
def test_edge_and_wire_bytes(config_name):
    cfg, w, frames, sel, prog = _setup(config_name)
    z_ref = ref.edge(w, cfg, frames)
    z = prog.edge(frames)
    assert_close(z, z_ref)
    for i in range(frames.shape[0]):
        zi = z[i:i + 1]
        blob = prog.plan.encode(zi)
        z_sel = zi[..., torch.as_tensor(sel)]
        mins, maxs = ref.side_info(z_sel)
        codes = ref.quantize(z_sel, mins, maxs, cfg["bits"])
        data = wire.write(codes.numpy(), mins, maxs, cfg["bits"])
        assert data == blob.data
        got, gmins, gmaxs = wire.read(blob.data, tuple(codes.shape),
                                      cfg["bits"])
        np.testing.assert_array_equal(got, codes.numpy())
        np.testing.assert_array_equal(gmins, mins)


@pytest.mark.parametrize("bits", [3, 8, 12])
def test_pack_round_trip_matches_the_ports_packing(bits):
    from repro_torch.core.codec import pack_bits
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (1, 4, 4, 16))
    assert wire.pack(codes, bits) == pack_bits(codes, bits)
    np.testing.assert_array_equal(
        wire.unpack(wire.pack(codes, bits), bits, codes.size),
        codes.ravel())
    np.testing.assert_array_equal(
        wire.from_stream(wire.to_stream(codes), codes.shape), codes)


def test_tiling_matches_the_ports():
    from repro_torch.core.tiling import tile_batch
    codes = np.arange(2 * 3 * 5 * 16).reshape(2, 3, 5, 16)
    want = tile_batch(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(wire.to_stream(codes),
                                  want.reshape(-1, want.shape[-1]))


def test_transposed_conv_matches_the_ports():
    from repro_torch.nn import conv_transpose_apply
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 6, 4, generator=gen)
    wt = torch.randn(7, 4, 3, 3, generator=gen)
    b = torch.randn(7, generator=gen)
    got = ref.conv_transpose_x2(x.permute(0, 3, 1, 2), wt, b)
    want = conv_transpose_apply(x, wt, b, stride=2).permute(0, 3, 1, 2)
    assert_close(got, want)


@pytest.mark.parametrize("config_name", ["yolo3-baf-c64", "yolo3-baf-c96"])
def test_restore_and_cloud(config_name):
    cfg, w, frames, sel, prog = _setup(config_name)
    blobs = [prog.plan.encode(prog.edge(frames[i:i + 1]))
             for i in range(frames.shape[0])]
    z_t = prog.plan.restore(prog.plan.decode_batch(blobs))
    shape = (1, *cfg["split_shape"][:2], cfg["c"])
    parts = [wire.read(b.data, shape, cfg["bits"]) for b in blobs]
    codes = torch.from_numpy(np.concatenate([p[0] for p in parts]))
    mins = np.concatenate([p[1] for p in parts])
    maxs = np.concatenate([p[2] for p in parts])
    z_ref = ref.restore(w, cfg, torch.as_tensor(sel), codes, mins, maxs)
    assert_close(z_t, z_ref)
    assert_close(prog.cloud(z_t), ref.cloud(w, cfg, z_ref))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      -3.0], dtype=torch.float32)
    got = ref.to_tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2**-11, 1.0, -3.0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
