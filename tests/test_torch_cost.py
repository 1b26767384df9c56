"""The port's program cost counter (``launch/hlo_cost.py``) and the
roofline seed of the sharded tier (``serve/mesh_executor.py``).

* ``analyze_program`` on the smoke system's restore + cloud body: its flops
  are the sum over its convolutions of 2·N·Ho·Wo·kh·kw·Cin·Cout (a
  transposed convolution counts its real multiply-adds over its input)
  and the dense head's 2·N·K·M; on the cloud half alone they equal the
  reference's ``analyze_compiled`` of ``jax.jit(cnn_cloud)``; on the whole
  body the reference counts more by exactly the zeros that XLA inserts
  into a transposed convolution (an lhs-dilated convolution).
* The bytes rule: materializing ops read their inputs once and write their
  outputs once, views are free; c10d collectives by kind.
* Each kernel wrapper charges one entry whose bytes are the kernel table's
  column in PERF.md at the table's shapes, with the ops of its plain
  version (which runs here) not counted.
* ``seed_cost_from_program``: positive, the float32 peak for the float32
  plan, and a seed that carries a single-size fit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.core.split import restore_codes as jax_restore_codes
from repro.launch.hlo_cost import analyze_compiled
from repro.models.cnn import cnn_cloud, init_cnn
from repro_torch import pipeline
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig
from repro_torch.kernels.consolidate import consolidate_fused
from repro_torch.kernels.flash_attention import (attention_mask,
                                                 flash_attention,
                                                 flash_attention_cost)
from repro_torch.kernels.histogram import cdf, histogram
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.quantize import quantize_fused
from repro_torch.launch import hlo_cost
from repro_torch.launch.hlo_cost import analyze_program
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32
from repro_torch.serve import CalibratedCostModel, seed_cost_from_program
from repro_torch.serve.mesh_executor import restore_cloud_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, HIDDEN, N = 8, 8, 4


@pytest.fixture(scope="module")
def system():
    jcfg = jax_smoke_config()._replace(input_size=32)
    tcfg = smoke_config()._replace(input_size=32)
    params = jax.tree.map(np.asarray, init_cnn(jax.random.PRNGKey(0), jcfg))
    baf = jax.tree.map(np.asarray, init_baf_conv(
        jax.random.PRNGKey(1), JBaFConfig(c=C, q=jcfg.split_q,
                                          hidden=HIDDEN)))
    model = cnn_from_jax(params, tcfg, device="cpu")
    tbaf = baf_from_jax(baf, BaFConvConfig(c=C, q=tcfg.split_q,
                                           hidden=HIDDEN), device="cpu")
    sel = np.arange(C)
    spec = pipeline.ModelSpec(sel_idx=sel, params=model, baf_params=tbaf)
    plans = {fused: pipeline.compile(pipeline.OperatingPoint(c=C, bits=8),
                                     spec, fused=fused, device="cpu")
             for fused in (True, False)}
    return dict(params=params, baf=baf, cfg=tcfg, model=model, plans=plans,
                sel=sel)


def _conv_flops(n, ho, wo, k, cin, cout):
    return 2 * n * ho * wo * k * k * cin * cout


def _cloud_flops(cfg, n):
    """The tail's residual pairs (1x1 then 3x3) at the split size, and the
    dense head."""
    hw, p, q = cfg.split_hw, cfg.split_p, cfg.ch(128)
    convs = cfg.tail_res_blocks * (_conv_flops(n, hw, hw, 1, p, q)
                                   + _conv_flops(n, hw, hw, 3, q, p))
    return convs + 2 * n * p * cfg.num_classes


def _restore_flops(cfg, n):
    """BaF backward: the x2 transposed conv counted over its (hw, hw)
    input, three 3x3 convs at 2hw; forward: the split conv, stride 2."""
    hw, p, q = cfg.split_hw, cfg.split_p, cfg.split_q
    return (_conv_flops(n, hw, hw, 3, C, HIDDEN)
            + 2 * _conv_flops(n, 2 * hw, 2 * hw, 3, HIDDEN, HIDDEN)
            + _conv_flops(n, 2 * hw, 2 * hw, 3, HIDDEN, q)
            + _conv_flops(n, hw, hw, 3, q, p))


def _body_inputs(cfg):
    hw = cfg.split_hw
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, (N, hw, hw, C)).astype(np.uint8)
    mins = (-rng.uniform(1, 2, (N, 1, 1, C))).astype(np.float16)
    maxs = rng.uniform(1, 2, (N, 1, 1, C)).astype(np.float16)
    return codes, mins, maxs


@pytest.mark.parametrize("fused", [True, False])
def test_restore_cloud_flops_are_the_sum_over_convolutions(system, fused):
    cfg = system["cfg"]
    plan = system["plans"][fused]
    codes, mins, maxs = (torch.from_numpy(a) for a in _body_inputs(cfg))
    est = analyze_program(lambda: plan.spec.params.cloud(
        plan.restore_device(codes, mins, maxs)))
    assert est["flops"] == _restore_flops(cfg, N) + _cloud_flops(cfg, N)
    assert est["collective_bytes"] == {}
    assert est["bytes"] == sum(est["bytes_by_op"].values()) > 0
    if fused:
        assert [k["name"] for k in est["kernels"]] == ["consolidate"]
        assert est["bytes_by_op"]["consolidate"] == \
            est["kernels"][0]["bytes"] == \
            2 * N * cfg.split_hw ** 2 * C * 4 + N * cfg.split_hw ** 2 * C \
            + 2 * N * C * 2 + C * 4
    else:
        assert est["kernels"] == []


def test_cloud_flops_equal_the_references(system):
    cfg = system["cfg"]
    z = np.random.default_rng(1).normal(
        size=(N, cfg.split_hw, cfg.split_hw, cfg.split_p)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, system["params"])
    want = analyze_compiled(jax.jit(cnn_cloud).lower(
        jparams, jnp.asarray(z)).compile())["flops"]
    got = analyze_program(system["model"].cloud, torch.from_numpy(z))
    assert got["flops"] == want == _cloud_flops(cfg, N)


def test_whole_body_gap_is_the_transposed_convs_inserted_zeros(system):
    """XLA lowers the x2 transposed conv as a convolution over the input
    dilated by inserted zeros: it counts 2·N·(2h)·(2w)·k²·Cin·Cout where
    the port (and the arithmetic) counts 2·N·h·w·k²·Cin·Cout."""
    cfg = system["cfg"]
    codes, mins, maxs = _body_inputs(cfg)
    sel = jnp.asarray(system["sel"])

    def body(bafp, p, codes, mins, maxs):
        z = jax_restore_codes(bafp, p["split"], sel, codes, mins, maxs,
                              bits=8, consolidation=True)
        return cnn_cloud(p, z)
    want = analyze_compiled(jax.jit(body).lower(
        jax.tree.map(jnp.asarray, system["baf"]),
        jax.tree.map(jnp.asarray, system["params"]), codes, mins,
        maxs).compile())["flops"]
    plan = system["plans"][True]
    got = analyze_program(lambda: plan.spec.params.cloud(plan.restore_device(
        *(torch.from_numpy(a) for a in (codes, mins, maxs)))))["flops"]
    hw = cfg.split_hw
    gap = _conv_flops(N, 2 * hw, 2 * hw, 3, C, HIDDEN) \
        - _conv_flops(N, hw, hw, 3, C, HIDDEN)
    assert want - got == gap > 0


def test_bytes_read_inputs_once_and_write_outputs_once():
    x = torch.ones(4, 8)
    y = torch.ones(4, 8)

    def prog(x, y):
        s = x + y                          # reads 2 x 128, writes 128
        t = s.t()                          # a view: free
        u = t.contiguous()                 # reads 128, writes 128
        u.mul_(2.0)                        # reads 128, writes 128
        buf = torch.empty(8, 4)            # an allocation: free
        buf.copy_(u)                       # reads 128, writes 128
        return buf @ torch.ones(4, 2)      # mm: 2·8·2·4 flops
    est = analyze_program(prog, x, y)
    assert est["bytes_by_op"]["add"] == 3 * 128
    assert est["bytes_by_op"]["clone"] == 2 * 128
    assert est["bytes_by_op"]["mul_"] == 2 * 128
    assert est["bytes_by_op"]["copy_"] == 2 * 128
    assert "t" not in est["bytes_by_op"] and "empty" not in est["bytes_by_op"]
    assert est["bytes_by_op"]["mm"] == 128 + 32 + 64
    assert est["flops"] == 2 * 8 * 2 * 4


COLLECTIVES = r"""
import json, sys, torch
import torch.distributed as dist
from repro_torch.launch.hlo_cost import analyze_program
dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
def prog():
    t = torch.ones(16)
    dist.all_reduce(t)
    out = torch.empty(16)
    dist.all_gather_into_tensor(out, t)
    dist.broadcast(t, 0)
est = analyze_program(prog)
dist.destroy_process_group()
print(json.dumps(est["collective_bytes"]))
"""


def test_collective_bytes_by_kind(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-c", COLLECTIVES,
                          str(tmp_path / "rendezvous")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        {"all-reduce": 64.0, "all-gather": 64.0, "broadcast": 64.0}


# ---------------------------------------------------------------------------
# the kernel wrappers' charges at the kernel table's shapes
# ---------------------------------------------------------------------------

def _gen():
    return torch.Generator().manual_seed(0)


def _quantize(b):
    x = torch.randn((b, 4096, 256), generator=_gen())
    sel = torch.randperm(256, generator=_gen())[:64].to(torch.int32)
    return lambda: quantize_fused(x, 8, sel)


def _histogram(k):
    codes = torch.randint(0, 256, (k, 64), generator=_gen(),
                          dtype=torch.uint8)
    return lambda: histogram(codes, 256)


def _consolidate():
    z = torch.randn((8, 4096, 256), generator=_gen())
    sel = torch.randperm(256, generator=_gen())[:64].to(torch.int32)
    codes, mins, maxs = quantize_fused(z, 8, sel)
    return lambda: consolidate_fused(z, codes, mins, maxs, 8, sel)


def _cdf(s):
    counts = torch.randint(0, 64, (s, 64), generator=_gen(),
                           dtype=torch.int32)
    return lambda: cdf(counts)


def _flash():
    g = _gen()
    q = torch.randn((2, 512, 28, 128), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((2, 512, 4, 128), generator=g).to(torch.bfloat16)
            for _ in range(2))
    return lambda: flash_attention(q, k, v, causal=True)


def _scan(s, h, chunk, mode, init):
    g = _gen()
    q, k = (torch.randn((2, s, h, 64), generator=g).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((2, s, h, 64), generator=g).to(torch.bfloat16)
    ld = -torch.rand((2, s, h, 64 if mode == "rwkv" else 1), generator=g)
    u = torch.randn((h, 64), generator=g) if mode == "rwkv" else None
    s0 = torch.randn((2, h, 64, 64), generator=g) if init else None
    return lambda: linear_scan(q, k, v, ld, bonus=u, initial_state=s0,
                               chunk=chunk, mode=mode)


def _scan_flops(b, s, h, d, chunk, mode):
    pairs = chunk * (chunk - 1) // 2 if mode == "rwkv" else \
        chunk * (chunk + 1) // 2
    per_chunk = (2 * pairs * d + 2 * pairs * d + 2 * chunk * d * d
                 + 2 * chunk * d * d + 3 * chunk * d + 5 * chunk * d)
    return float(b * h * (s // chunk) * per_chunk)


# (name, program, the kernel table's bytes, flops)
TABLE = [
    ("quantize", lambda: _quantize(1), 1_311_232, 0.0),
    ("quantize", lambda: _quantize(8), 10_488_064, 0.0),
    ("histogram", lambda: _histogram(4096), 327_680, 0.0),
    ("histogram", lambda: _histogram(32768), 2_162_688, 0.0),
    ("consolidate", _consolidate, 18_876_672, 0.0),
    ("cdf", lambda: _cdf(256), 131_072, 0.0),
    ("cdf", lambda: _cdf(4096), 2_097_152, 0.0),
    ("flash_attention", _flash, 16_777_216,
     4.0 * 2 * 28 * 128 * (512 * 513 // 2)),
    ("linear_scan", lambda: _scan(512, 40, 16, "rwkv", False), 38_021_120,
     _scan_flops(2, 512, 40, 64, 16, "rwkv")),
    ("linear_scan", lambda: _scan(1024, 40, 16, "rwkv", True), 76_032_000,
     _scan_flops(2, 1024, 40, 64, 16, "rwkv")),
    ("linear_scan", lambda: _scan(512, 64, 128, "ssm", False), 44_302_336,
     _scan_flops(2, 512, 64, 64, 128, "ssm")),
]


@pytest.mark.parametrize("case", range(len(TABLE)),
                         ids=[f"{t[0]}-{t[2]}" for t in TABLE])
def test_kernel_charge_is_the_tables_bytes(case):
    name, make, nbytes, flops = TABLE[case]
    est = analyze_program(make())
    assert est["kernels"] == [{"name": name, "flops": flops,
                               "bytes": float(nbytes)}]
    # the plain version's ops ran with counting suspended
    assert est["bytes_by_op"] == {name: float(nbytes)}
    assert est["flops"] == flops and est["bytes"] == nbytes


def test_detect_head_flash_charge_is_the_tables_bytes():
    """(8, 4096, 2, 16) float32, not causal: 16,777,216 bytes. Its plain
    version's (8, 2, 4096, 4096) scores would take 1 GB here, so the
    charge is read from shapes alone (meta tensors)."""
    q, k, v = (torch.empty((8, 4096, 2, 16), device="meta")
               for _ in range(3))
    flops, nbytes = flash_attention_cost(q, k, v, causal=False)
    assert nbytes == 16_777_216
    assert flops == 4.0 * 8 * 2 * 16 * 4096 * 4096


@pytest.mark.parametrize("sq,sk,causal,window", [
    (8, 8, True, None), (5, 12, True, None), (7, 7, True, 3),
    (6, 10, False, None), (6, 10, False, 4), (3, 9, True, 20)])
def test_flash_charge_counts_the_pairs_the_mask_keeps(sq, sk, causal, window):
    q = torch.randn(2, sq, 4, 8)
    k = v = torch.randn(2, sk, 2, 8)
    kept = int(attention_mask(sk - sq, sq, sk, causal=causal,
                              window=window).sum())
    est = analyze_program(lambda: flash_attention(q, k, v, causal=causal,
                                                  window=window))
    assert est["kernels"][0]["flops"] == 4.0 * 2 * 4 * 8 * kept


def test_wrappers_charge_nothing_without_a_counter():
    assert hlo_cost._ACTIVE.get() is None
    codes = torch.randint(0, 16, (64, 3), dtype=torch.uint8)
    assert torch.equal(histogram(codes, 16).sum(1),
                       torch.full((3,), 64, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the roofline seed
# ---------------------------------------------------------------------------

def test_seed_cost_from_program_positive(system):
    plan = system["plans"][True]
    shape = (4, 4, 4, C)
    m = seed_cost_from_program(plan, shape)
    assert isinstance(m, CalibratedCostModel)
    assert not m.frozen
    assert m.seed_per_item_s > 0.0
    est = restore_cloud_cost(plan, shape)
    assert m.seed_per_item_s == max(est["flops"] / PEAK_FLOPS_F32,
                                    est["bytes"] / HBM_BW) / 4
    assert seed_cost_from_program(plan, shape, flops_per_s=1.0) \
        .seed_per_item_s == est["flops"] / 4
    # the roofline seed carries an otherwise-degenerate single-size fit
    m.observe(8, 0.02)
    m.freeze()
    assert m.per_item_s == m.seed_per_item_s
