"""Compression-plan + adaptive rate control demo.

    PYTHONPATH=src python -m repro_torch.launch.gateway_demo [--fast] \
        [--device cpu]

Counterpart of ``examples/gateway_demo.py`` (default device: the card):

1. pretrain the tiny Tier-A CNN and train one BaF predictor per C,
2. compile a CompressionPlan from a declarative OperatingPoint and run one
   request through encode -> decode_batch -> restore by hand (the staged
   API everything below is built on),
3. build the offline rate-distortion table by sweeping operating points with
   the repo's fidelity metrics (serve/rate_control.py),
4. set a PSNR quality floor and serve the same traffic through gateways whose
   channels grant a full and a HALVED per-tick bit budget — the controller
   moves to a cheaper operating point while staying at/above the floor,
5. multi-tenant serving over one shared uplink (premium + best effort
   through the DRR scheduler),
6. capability negotiation: a gateway that does not speak rANS downgrades
   the operating point to zlib instead of failing on the cloud side,
7. overload: a 3x burst against a multi-queue cloud executor with
   priority-tiered admission — best effort browns out first, every
   rejection is an explicit RequestShed, and telemetry keeps the shed
   series apart from the served-latency percentiles.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import pipeline
from repro_torch.configs.yolo_baf import smoke_config, smoke_data_config
from repro_torch.core.split import cnn_fns
from repro_torch.data.synthetic import shapes_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.serve import (Capabilities, ChannelConfig,
                               ContentKeyedController, LinearCostModel,
                               MultiQueueExecutor, MultiTenantGateway,
                               QueueDepthAdmission, RateController,
                               RequestShed, ServingGateway, SimulatedChannel,
                               TenantRequest, TenantSpec, build_rd_table,
                               priority_depth_limits)
from repro_torch.train.baf_trainer import (compute_channel_order,
                                           pretrain_cnn, train_baf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cnn_cfg = smoke_config()._replace(input_size=32)
    data_cfg = smoke_data_config()._replace(image_size=32, batch_size=8)

    def batch(cfg, seed) -> np.ndarray:
        """One batch of the synthetic stream, as the host's numpy images."""
        img, _ = next(shapes_batch_iterator(cfg, seed=seed, device=dev))
        return img.cpu().numpy()

    print(f"== 1. train tiny CNN + per-C BaF bank on {dev} ==")
    model, _ = pretrain_cnn(cnn_cfg, data_cfg,
                            steps=40 if args.fast else 150, verbose=False,
                            device=dev)
    order = compute_channel_order(model, data_cfg, batches=4,
                                  device=dev).order
    bank = {}
    for c in (4, 8, 16):
        res = train_baf(model, cnn_cfg, data_cfg, order[:c], bits=8, hidden=8,
                        steps=40 if args.fast else 150, verbose=False,
                        device=dev)
        bank[c] = (res.baf_params, res.sel_idx)
        print(f"  BaF trained for C={c}")

    print("== 1b. the plan API: one operating point, end to end ==")
    op = pipeline.OperatingPoint(c=8, bits=6, backend="rans")
    spec = pipeline.ModelSpec(sel_idx=np.asarray(bank[8][1]), params=model,
                              baf_params=bank[8][0])
    plan = pipeline.compile(op, spec, device=dev)
    edge_fn, cloud_fn = cnn_fns(model)
    demo = plan.to_device(batch(data_cfg._replace(batch_size=1), 1))
    blobs = [plan.encode(edge_fn(demo)) for _ in range(4)]
    decoded = plan.decode_batch(blobs)          # one vectorized host decode
    z_tilde = plan.restore(decoded)             # one batched BaF restore
    logits = cloud_fn(z_tilde)
    print(f"  op {op.resolve()}")
    print(f"  4 requests -> {sum(b.nbytes for b in blobs)} wire bytes, "
          f"decode_batch {decoded.codes.shape}, logits "
          f"{tuple(logits.shape)}")

    print("== 2. offline rate-distortion table (C x bits sweep) ==")
    imgs = batch(data_cfg, 99)
    table = build_rd_table(model, bank, imgs, bits_sweep=(2, 4, 8),
                           device=dev)
    print(f"{'C':>4} {'bits':>5} {'wire bits/img':>14} {'psnr_db':>8} "
          f"{'kl':>8}")
    for p in sorted(table, key=lambda p: p.bits_per_example):
        print(f"{p.op.c:>4} {p.op.bits:>5} {p.bits_per_example:>14.0f} "
              f"{p.psnr_db:>8.2f} {p.kl:>8.4f}")

    floor_db = float(np.median([p.psnr_db for p in table]))
    rc = RateController(table, quality_floor_db=floor_db)
    print(f"quality floor: {floor_db:.2f} dB "
          f"(cheapest point meeting it: {rc.cheapest_meeting_floor().op})")

    print("== 3. serve under full vs halved channel bit budget ==")
    meeting = [p for p in table if p.psnr_db >= floor_db]
    budget_full = int(1.05 * max(p.bits_per_example for p in meeting))
    budget_half = budget_full // 2
    traffic = batch(data_cfg._replace(batch_size=4), 2024)

    chosen = {}
    for label, budget in (("full", budget_full), ("half", budget_half)):
        ch = SimulatedChannel(ChannelConfig(bandwidth_bps=2e6,
                                            base_latency_s=0.01, tick_s=10.0,
                                            budget_bits_per_tick=budget))
        gw = ServingGateway(model, bank, controller=rc, channel=ch,
                            max_batch=4, device=dev)
        # the first request of each tick sees the full budget: that choice
        # is the operating point the controller assigns to this condition
        responses, _ = gw.serve(traffic[:1])
        chosen[label] = responses[0]
        print(f"budget {label:>4} ({budget:>7} bits/tick) -> "
              f"op {responses[0].op}, wire bits "
              f"{responses[0].stats.total_bits}")

    full_op, half_op = chosen["full"].op, chosen["half"].op
    full_pt = next(p for p in table if p.op == full_op)
    half_pt = next(p for p in table if p.op == half_op)
    print(f"\nfull-budget op {full_op}: psnr {full_pt.psnr_db:.2f} dB")
    print(f"half-budget op {half_op}: psnr {half_pt.psnr_db:.2f} dB")
    assert full_op != half_op, "halving the budget should change the op point"
    assert full_pt.psnr_db >= floor_db and half_pt.psnr_db >= floor_db, \
        "both operating points must respect the quality floor"
    print("OK: halved budget moved to a cheaper operating point, floor "
          "respected")

    print("\n== 4. mixed traffic on the half-budget channel ==")
    ch = SimulatedChannel(ChannelConfig(bandwidth_bps=2e6, base_latency_s=0.01,
                                        tick_s=0.05,
                                        budget_bits_per_tick=budget_half))
    gw = ServingGateway(model, bank, controller=rc, channel=ch, max_batch=4,
                        device=dev)
    _, tel = gw.serve(traffic)
    print(tel.format_summary())

    print("\n== 5. multi-tenant: premium + best-effort share one uplink ==")
    # Two tenants compete for a shared per-tick bit budget through the DRR
    # scheduler: "premium" carries 3x the weight and a strict PSNR floor,
    # "besteffort" takes what is left. The content-keyed controller shifts
    # each request's RD estimates by its own activation statistics.
    ck = ContentKeyedController(table, quality_floor_db=floor_db)
    tenants = [TenantSpec("premium", weight=3.0, quality_floor_db=floor_db),
               TenantSpec("besteffort", weight=1.0, quality_floor_db=0.0)]
    mt = MultiTenantGateway(
        model, bank, tenants=tenants, controller=ck,
        channel_cfg=ChannelConfig(bandwidth_bps=2e6, base_latency_s=0.01),
        budget_bits_per_tick=budget_full, tick_s=0.05,
        max_batch=4, batch_window_s=0.02, device=dev)
    stream = batch(data_cfg, 7)
    work = [TenantRequest(tenant=("premium", "besteffort")[i % 2],
                          img=stream[i % len(stream)], t_submit=0.004 * i)
            for i in range(12)]
    mt_resp, mt_tel = mt.serve_tenants(work)
    print(mt_tel.format_summary())
    shares = mt.last_scheduler.grant_shares()
    print(f"uplink grant shares : premium {shares['premium']:.2f}, "
          f"besteffort {shares['besteffort']:.2f}")
    assert len(mt_resp["premium"]) == 6 and len(mt_resp["besteffort"]) == 6
    print("OK: both tenants fully served over the shared budget")

    print("\n== 6. capability negotiation: a zlib-only gateway meets rANS ==")
    rans_op = pipeline.OperatingPoint(c=8, bits=8, backend="rans")
    legacy = ServingGateway(model, bank, default_op=rans_op,
                            capabilities=Capabilities(backends=("zlib",)),
                            max_batch=4, device=dev)
    resp, _ = legacy.serve(traffic[:2])
    print(f"requested {rans_op.backend!r} -> served on "
          f"{resp[0].op.wire_backend!r} (downgraded, not refused)")
    assert resp[0].op.wire_backend == "zlib"
    try:
        ServingGateway(model, bank, default_op=rans_op,
                       capabilities=Capabilities(backends=("zlib",),
                                                 downgrade=False),
                       device=dev)
    except pipeline.NegotiationError as e:
        print(f"strict gateway refuses instead: {e}")
    else:
        raise AssertionError("a strict zlib-only gateway accepted rANS")
    print("OK: negotiation decided before any bytes were encoded")

    print("\n== 7. overload: 3x burst through priority tiers, explicit "
          "shed ==")
    # The cloud is 2 parallel queues on a deterministic cost model: capacity
    # is 2 queues * 4 req / (4 ms + 4 * 1 ms) = 1000 req/s. The burst offers
    # 3x that. Queue-depth admission holds a tier ladder — bronze sheds at
    # backlog 2, silver at 4, gold at 6 — so the brown-out eats best effort
    # first while gold keeps flowing.
    cost = LinearCostModel(base_s=0.004, per_item_s=0.001)
    tiers = [TenantSpec("gold", weight=2.0, priority=2),
             TenantSpec("silver", priority=1),
             TenantSpec("bronze", priority=0)]
    ov = MultiTenantGateway(
        model, bank, tenants=tiers,
        channel_cfg=ChannelConfig(bandwidth_bps=50e6, base_latency_s=0.001),
        default_op=pipeline.OperatingPoint(c=8, bits=8), max_batch=4,
        batch_window_s=0.002,
        executor=MultiQueueExecutor(2, cost=cost),
        admission=QueueDepthAdmission(
            2, per_priority=priority_depth_limits(2, [0, 1, 2], headroom=2)),
        device=dev)
    burst = [TenantRequest(("gold", "silver", "bronze")[i % 3],
                           stream[i % len(stream)], t_submit=i / 3000.0)
             for i in range(48)]
    ov_resp, ov_tel = ov.serve_tenants(burst)
    print(ov_tel.format_summary())
    served = {t: sum(not isinstance(r, RequestShed) for r in rs)
              for t, rs in ov_resp.items()}
    shed = ov_tel.shed_by_tenant()
    for t in ("gold", "silver", "bronze"):
        print(f"  {t:<7}: served {served[t]:>2}, shed {shed.get(t, 0):>2}")
    assert sum(served.values()) + len(ov_tel.shed) == len(burst), \
        "silent drop!"
    assert shed.get("bronze", 0) >= shed.get("gold", 0)
    if ov_tel.shed:
        print(f"example shed reason: {ov_tel.shed[0].reason!r}")
    print("OK: 3x burst browned out low tiers first; every request ended as "
          "a response or an explicit RequestShed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
